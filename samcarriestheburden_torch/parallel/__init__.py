"""Multi-process scale-out on ``torch.distributed`` (JAX ``parallel/``):
``distributed`` joins the process group and shards host-side work, ``mesh``
is the data axis over the ranks, ``worker`` is the module a multi-process
check spawns (``python -m samcarriestheburden_torch.parallel.worker JOB ...``)
to run the jobs of ``_harness`` (the test harness), and ``dryrun`` spawns it
for one data-parallel training step and one strided encoder batch.  One card
per process: NCCL across cards, gloo on the CPU or for ranks that share one
card.

``make_hybrid_mesh``, ``host_value``, ``global_batch``, ``batch_sharding``,
``replicated`` and ``Sharding`` keep the JAX package's names so that a reader
finds the counterpart; only the tests call them."""
