"""Multi-device runs of the port (counterpart of ``shotgun_tpu/parallel/``):
reads sharded over a mesh of devices (``mesh.py``), the key-sorted table
range-partitioned over a ``table`` axis (``table_sharded.py``), and
processes joined by ``torch.distributed`` (``distributed.py``)."""
