"""Subpackage: parallel — scenario data parallelism over torch.distributed."""
