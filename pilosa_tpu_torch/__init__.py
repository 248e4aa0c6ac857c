"""PyTorch and CUDA port of the TPU-native distributed bitmap index.

The JAX package ``pilosa_tpu`` is the reference; this package answers
the same PQL over the same data on an NVIDIA GPU (Hopper), through
hand-written CUDA kernels, and imports nothing of JAX or of the
reference. Entry points run on CUDA unless given ``device="cpu"``.

``Holder()`` lives in memory; ``Holder(path)`` (then ``open()``) keeps
its indexes in a data directory in the JAX package's layout and roaring
file format, which either package opens (``close()`` saves the count
caches). ``Bitmap`` is the roaring container store of a fragment, with
the file codec.

The names below load on first use, so a tool that needs none of them
(``cli check``, ``fold``, ``backup``) starts without importing torch.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "Bitmap": "pilosa_tpu_torch.storage.roaring",
    "Executor": "pilosa_tpu_torch.executor",
    "FieldOptions": "pilosa_tpu_torch.core.field",
    "Holder": "pilosa_tpu_torch.core.holder",
    "load_state": "pilosa_tpu_torch.core.state",
}
__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'pilosa_tpu_torch' has no attribute "
                             f"{name!r}")
    import importlib
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
