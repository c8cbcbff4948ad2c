"""The distribution layer: the mesh's ambient state (``hints``), the
sharding rules and the local blocks they give each rank (``sharding``),
and the int8 error-feedback gradient all-reduce (``collectives``), on
``torch.distributed``."""
