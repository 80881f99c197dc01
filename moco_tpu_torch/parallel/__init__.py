"""ShuffleBN batch permutation on one process."""
