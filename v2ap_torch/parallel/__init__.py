"""Data x model (Megatron tensor) parallelism over ``torch.distributed``:
the counterpart of ``v2ap_tpu.parallel``. The sharding rules import the
model classes, so they load on first use: ``parallel.state`` and
``parallel.distributed`` stay free of them."""

from v2ap_torch.parallel.mesh import make_mesh, batch_sharding, replicated  # noqa: F401

_SHARDING = ("shard_model", "state_shardings", "param_spec")


def __getattr__(name):
    if name in _SHARDING:
        from v2ap_torch.parallel import sharding
        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
