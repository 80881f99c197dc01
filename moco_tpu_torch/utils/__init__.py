"""Console meters and device selection of the port's entry points."""
