"""Evaluations of a pretrained encoder: the linear probe (`lincls`) and
the kNN eval (`knn`), each with an entry point of its own
(`python -m moco_tpu_torch.evals.lincls`, `python -m moco_tpu_torch.evals.knn`)."""
