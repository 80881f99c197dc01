"""The input service's pieces that are ported: the pre-staged epoch cache."""
