"""The device mesh and the process gang.

Port of ``photon_ml_tpu/parallel/``: the mesh (``mesh.py``), the shard
runner and its collectives (``collectives.py``), the int8 wire format
(``quantized_collectives.py``), the data-sharded GLM fit
(``distributed.py``), the multi-device acceptance step
(``multichip_check.py``) and the multi-process gang over
``torch.distributed`` (``multihost.py``), whose mesh axes may span
processes.
"""
