"""Synthetic data and the on-device two-crop augmentation."""
