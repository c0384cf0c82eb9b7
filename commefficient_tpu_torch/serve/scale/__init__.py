"""The scale-out socket engine: ``eventloop``, the selectors reactor (the
default ``--serve_transport``). The reference's sharded ingest, process
shards, shared-memory ring, load generator and edge tree are not ported
(ROADMAP Queue 1 item 9b)."""
