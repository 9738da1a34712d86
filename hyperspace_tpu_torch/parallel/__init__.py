"""Process- and device-level parallelism of the port: the spawn-context
worker pool of the pooled index build (`procpool.py`) and the device mesh
with its collectives (`mesh.py`).

The mesh re-exports are lazy, as the JAX package's are: the pooled
build's spawned workers import `parallel.procpool`, which runs this file
first, and need nothing of the mesh."""

__all__ = ["default_mesh", "make_mesh"]


def __getattr__(name):
    if name in ("default_mesh", "make_mesh"):
        from hyperspace_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(name)
