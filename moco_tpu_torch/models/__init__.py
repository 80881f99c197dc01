"""ResNet encoders with the port's train-mode BatchNorm."""
