"""Parallelism over ``torch.distributed`` (counterpart of
``spmm_tpu.parallel``): the device mesh and its groups (``mesh``), the
multi-process glue (``multihost``), tensor, sequence and fully-sharded
parallelism of the pretrain step (``tp``, ``sp``, ``fsdp``) and
data-parallel inference over several cards (``replicas``).  Pipeline and
expert parallelism are not ported yet."""
