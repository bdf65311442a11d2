"""Parallelism over ``torch.distributed`` (counterpart of
``spmm_tpu.parallel``): the device mesh and its groups (``mesh``), the
multi-process glue (``multihost``), tensor, sequence and fully-sharded
parallelism of the pretrain step (``tp``, ``sp``, ``fsdp``), data-parallel
inference over several cards (``replicas``), pipeline parallelism over the
text section (``pp``), the mixture-of-experts block and expert parallelism
(``ep``), and the entry points that drive every one of them (``dryrun``)."""
