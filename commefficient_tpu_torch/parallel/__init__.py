"""Ranks and the client mesh of the port's sharded round: ``mesh``
(``ClientMesh``, ``parse_mesh_spec``, ``merge_comm_bytes``) and
``distributed`` (joining the process group, the preemption agreement and
the ordered gather of the shards' partials)."""
