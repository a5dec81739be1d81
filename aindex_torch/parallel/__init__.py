"""The multi-device build and query paths of aindex_torch on
``torch.distributed``: the (data, index) device mesh (``mesh``), joining a
job and the rank-level helpers (``distributed``), the data-parallel dense
count (``count13``), the key-range-sharded spectrum (``spectrum23``), the
node-sharded sparse query engine (``query23``) and the slot-range-sharded
positional fill (``positional``).

Each sharded step is a local function of plain tensors and a shard index
(a kernel wrapper, with its plain version on the CPU) inside a thin shell
of collectives over one axis of the mesh, so the local steps of N shards
can also run in one process.
"""
