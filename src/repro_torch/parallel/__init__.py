"""The distribution layer: the mesh's ambient state (``hints``), the
sharding rules and the local blocks they give each rank (``sharding``),
the sharded train step's per-layer gather (``fsdp``), Megatron tensor
parallelism's ops over the ``model`` axis (``tp``), and the int8
error-feedback gradient all-reduce (``collectives``), on
``torch.distributed``."""
