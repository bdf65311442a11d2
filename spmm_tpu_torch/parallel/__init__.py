"""Data parallelism over ``torch.distributed`` (counterpart of
``spmm_tpu.parallel``): the data-parallel group (``mesh``) and the
multi-process glue (``multihost``).  Tensor, sequence, fully-sharded,
pipeline and expert parallelism are not ported yet."""
