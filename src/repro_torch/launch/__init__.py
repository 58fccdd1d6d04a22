"""Launchers of the PyTorch/CUDA port (mirrors ``repro.launch``): the
card's constants (``hw``), meshes (``mesh``), the partition-spec policy
(``sharding``), the dry run (``dryrun``), and the serving and training
launchers (``serve``, ``train``).

``hw``, ``mesh`` and ``sharding`` are the package's names, as the
reference's, but each is imported on first use: importing ``hw`` (no
dependencies) does not load the meshes and the distributed layer."""
import importlib

__all__ = ["hw", "mesh", "sharding"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
