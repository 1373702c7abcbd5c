"""The parallel layer (port of clpathtracer_tpu/parallel): the JAX
package's names, loaded on first use (render/integrator.py imports
parallel/treelet.py, and parallel/mesh.py imports the integrator). Its
`replicated` and `row_sharded` sharding objects have no counterpart: a
tensor lives on its rank."""

_NAMES = {
    "default_mesh": "mesh", "make_sharded_renderer": "mesh",
    "render_image_sharded": "mesh", "TrainState": "train",
    "apply_params": "train", "make_train_step": "train",
}
__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"),
                   name)
