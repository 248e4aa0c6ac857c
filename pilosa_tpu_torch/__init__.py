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
"""

__version__ = "0.1.0"

from pilosa_tpu_torch.core.field import FieldOptions  # noqa: F401
from pilosa_tpu_torch.core.holder import Holder  # noqa: F401
from pilosa_tpu_torch.core.state import load_state  # noqa: F401
from pilosa_tpu_torch.executor import Executor  # noqa: F401
from pilosa_tpu_torch.storage.roaring import Bitmap  # noqa: F401
