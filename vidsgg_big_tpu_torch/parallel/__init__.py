"""Data and tensor parallelism over several ranks (``--data_parallel``,
``--mesh D[,M]``): process groups and launch in ``mesh.py``, the
tensor-parallel parameter plan in ``sharding.py``."""
