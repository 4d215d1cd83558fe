"""Multi-process training: the (data, model) layout of the ranks
(``mesh.py``), the process-group bootstrap (``distributed.py``) and the
collectives of Megatron-style tensor parallelism (``tensor_parallel.py``)."""
