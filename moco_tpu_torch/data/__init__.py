"""Datasets, the native JPEG stager, the decode-once cache, the staging
pipeline (`loader.Prefetcher`) and the on-device two-crop augmentation."""
