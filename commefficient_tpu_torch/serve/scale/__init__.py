"""The scale-out serving layer (the port's copy of the JAX package's
``serve/scale/``):

- ``eventloop`` — the selectors reactor, the default ``--serve_transport``;
- ``shard``     — ``--serve_shards N``: N reactor threads over the one
  admission queue, clients routed by client-id hash (``shard_for``);
- ``procshard`` and ``procshard_worker`` — ``--serve_shard_mode process``:
  N SO_REUSEPORT worker processes, each owning its clients' admission
  state; ``shmring``, the shared-memory table ring they hand validated
  tables over in; ``spawn``, how they start (never importing torch);
- ``loadgen``   — the multi-process closed-loop load generator;
- ``edge``      — ``--serve_edges E``: the two-tier edge tree, E edge
  aggregators that each sum their hash shard's tables and forward one
  partial to the root (``EdgeTree``, ``assign_edges``).

Nothing is imported here: a worker process's import chain passes through
this package and stays numpy and standard library only.
"""
