"""Tensor and expert parallelism over ``torch.distributed`` (port of
``xbitops_tpu/parallel/``): one process a rank, each holding its own shard."""
