"""The device mesh: data- and entity-sharded solves in one process.

Port of ``photon_ml_tpu/parallel/`` without ``multihost.py``: the mesh
(``mesh.py``), the shard runner and its collectives (``collectives.py``),
the int8 wire format (``quantized_collectives.py``), the data-sharded GLM
fit (``distributed.py``) and the multi-device acceptance step
(``multichip_check.py``).
"""
