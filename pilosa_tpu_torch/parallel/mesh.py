"""Device mesh and shard placement, after the JAX package's
``parallel/mesh.py``.

One process drives the mesh, as the JAX package's single controller
does. A ``MeshContext`` is a list of local torch devices, split into an
optional leading replica axis and the shard axis; repeats are allowed,
so four slices of one card (or four ``cpu`` entries) make a four-part
mesh. The shard axis splits in contiguous blocks, as
``NamedSharding(P(None, 'shards', None))`` splits it: with the shard
list padded to a multiple of D shard devices, device ``d`` holds padded
shards ``[d·S/D, (d+1)·S/D)``. Under ``replicas > 1`` device ``r·D + d``
holds a copy of part ``d``; reads use replica 0's parts and never sum
across replicas.

A sharded bank or row is a ``MeshTensor``: one contiguous tensor a
part, the logical tensor being their concatenation along its shard
axis. It stands in for a torch tensor through ``__torch_function__``:

- an elementwise op (the bitwise folds, comparisons, ``where``,
  ``zeros_like``), an index or slice that leaves the shard axis whole,
  ``unsqueeze``, ``index_select`` off the shard axis, a reshape of the
  leading axes and a pad of the word axis run part by part, each on its
  part's device; a plain operand that spans the shard axis is split to
  match;
- anything else runs on the all-gathered tensor (the parts concatenated
  on the mesh's first device), as GSPMD inserts an all-gather before an
  op it cannot partition; an in-place op of that kind writes its result
  back into the parts.

The kernel wrappers of ``ops/kernels.py`` take a ``MeshTensor`` bank
part by part: one launch a part, the count vectors summed on the mesh's
first device (``psum``), row lanes concatenated along S there
(``all_gather``). On one device both are a plain add and a
``torch.cat``; across distinct CUDA devices the parts' partials reach
the first device by device-to-device copies. No partial goes to the
host before the reduction.

Reference note: ``ShardPlacement.device_of`` is the JAX package's as
written, round-robin over the padded list (``index % n``), while
``put_bank`` places contiguous blocks, so ``device_of`` can name
another device than the one holding a shard. Both are kept as written.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import torch


class ShardPlacement:
    """Static block placement of a shard list onto n devices."""

    def __init__(self, n_devices: int):
        self.n = n_devices

    def pad(self, shards: Sequence[int], floor: int = 0) -> List[int]:
        """Pad the shard list to a multiple of n with absent shard ids
        (from ``max(floor, max(shards) + 1)`` on), which hold all-zero
        bank columns and add nothing to any reduction. ``floor`` must
        exceed every existing shard of the index, not only the requested
        subset, or a pad id could alias a real shard the caller
        excluded."""
        shards = list(shards)
        if not shards:
            shards = [0]
        rem = (-len(shards)) % self.n
        if rem:
            pad_base = max(floor, max(shards) + 1)
            shards = shards + [pad_base + i for i in range(rem)]
        return shards

    def device_of(self, shards: Sequence[int], shard: int) -> int:
        """Which device owns a shard (for diagnostics and routing), the
        JAX package's round-robin rule."""
        padded = self.pad(shards)
        return padded.index(shard) % self.n


def _mesh_devices(devices: Optional[Sequence[Any]]) -> List[torch.device]:
    """The mesh's devices: as given (repeats allowed), or every visible
    CUDA device. A CUDA device without a card raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] "
                "to build a mesh on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        dev = torch.device(d)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available for a mesh of "
                    f"{dev}; pass devices=['cpu', ...] to run on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"unsupported mesh device {dev}")
        out.append(dev)
    if not out:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in out}) > 1:
        raise ValueError(f"mesh devices of mixed types: {out}")
    return out


class MeshContext:
    """A one- or two-axis mesh of local devices: an optional 'replica'
    axis by the 'shards' axis."""

    SHARD_AXIS = "shards"
    REPLICA_AXIS = "replica"

    def __init__(self, devices: Optional[Sequence[Any]] = None,
                 replicas: int = 1):
        devices = _mesh_devices(devices)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if len(devices) % replicas:
            raise ValueError(
                f"{len(devices)} devices not divisible by "
                f"{replicas} replicas")
        self.devices = devices
        self.replicas = replicas
        self.n_shard_devices = len(devices) // replicas
        D = self.n_shard_devices
        # grid[r][d]: replica r's device for shard part d.
        self.grid = [devices[r * D:(r + 1) * D] for r in range(replicas)]
        self.placement = ShardPlacement(D)

    @property
    def device(self) -> torch.device:
        """The mesh's first device, where the collectives land."""
        return self.devices[0]

    @property
    def shape(self) -> Dict[str, int]:
        if self.replicas > 1:
            return {self.REPLICA_AXIS: self.replicas,
                    self.SHARD_AXIS: self.n_shard_devices}
        return {self.SHARD_AXIS: self.n_shard_devices}

    def cache_key(self) -> str:
        dev_ids = tuple(str(d) for d in self.devices)
        return f"mesh{self.replicas}x{self.n_shard_devices}:{hash(dev_ids)}"

    # -- placement -----------------------------------------------------------

    def _split(self, t: torch.Tensor, axis: int) -> "MeshTensor":
        n = int(t.shape[axis])
        D = self.n_shard_devices
        if n % D:
            raise ValueError(
                f"shard axis of {n} does not split evenly over {D} shard "
                f"devices; pad the shard list first (pad_shards)")
        step = n // D
        blocks = [t.narrow(axis, d * step, step).contiguous()
                  for d in range(D)]
        copies = [[blocks[d].to(dev) for d, dev in enumerate(row)]
                  for row in self.grid]
        return MeshTensor(self, copies[0], axis, copies)

    @staticmethod
    def _tensor(host: Any) -> torch.Tensor:
        if isinstance(host, torch.Tensor):
            return host
        import numpy as np
        host = np.ascontiguousarray(host)
        if host.dtype == np.uint32:
            host = host.view(np.int32)
        return torch.from_numpy(host)

    def put_bank(self, host: Any) -> "MeshTensor":
        """A host (or device) ``[R, S, W]`` block as a sharded bank: one
        contiguous ``[R, S/D, W]`` tensor a shard device (a slice along S
        is not contiguous for R > 1, and the kernels need contiguous
        input); uint32 words become int32 of the same bits."""
        return self._split(self._tensor(host), 1)

    def put_row(self, arr: Any) -> "MeshTensor":
        """A ``[S, W]`` (or ``[k, S, W]``) array with the shard axis
        split."""
        t = self._tensor(arr)
        return self._split(t, 0 if t.dim() == 2 else 1)

    def pad_shards(self, shards: Sequence[int], floor: int = 0) -> List[int]:
        return self.placement.pad(shards, floor)

    # -- collectives ---------------------------------------------------------

    def psum(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """The count reduction: the parts' vectors summed on the mesh's
        first device."""
        out = partials[0].to(self.device)
        for p in partials[1:]:
            out = out + p.to(self.device)
        return out

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int
                   ) -> torch.Tensor:
        """The row gather: the parts concatenated along ``dim`` on the
        mesh's first device."""
        return torch.cat([p.to(self.device) for p in parts], dim=dim)


# ------------------------------------------------------------ MeshTensor

# Ops that act on each element (or each word) alone: run part by part.
_ELEMENTWISE = frozenset({
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift",
    "__and__", "__or__", "__xor__", "__rand__", "__ror__", "__rxor__",
    "__invert__", "__lshift__", "__rshift__", "__rlshift__",
    "__rrshift__", "__iand__", "__ior__", "__ixor__", "__ilshift__",
    "__irshift__", "bitwise_and_", "bitwise_or_", "bitwise_xor_",
    "bitwise_not_", "logical_and", "logical_or", "logical_not",
    "logical_xor", "eq", "ne", "__eq__", "__ne__", "add", "sub", "mul",
    "__add__", "__sub__", "__mul__", "__radd__", "__rmul__", "where",
    "zeros_like", "ones_like", "empty_like", "full_like", "clone",
    "contiguous", "detach", "copy_", "zero_", "fill_",
})


_INPLACE_DUNDERS = frozenset({
    "__iand__", "__ior__", "__ixor__", "__ilshift__", "__irshift__",
    "__iadd__", "__isub__", "__imul__", "__setitem__",
})


def _is_inplace(name: str) -> bool:
    if name.startswith("__"):
        return name in _INPLACE_DUNDERS
    return name.endswith("_")


def _gathered(x: Any) -> Any:
    if isinstance(x, MeshTensor):
        return x.gather()
    if isinstance(x, (list, tuple)):
        return type(x)(_gathered(v) for v in x)
    if isinstance(x, dict):
        return {k: _gathered(v) for k, v in x.items()}
    return x


def _find_mesh(args: Sequence[Any], kwargs: Dict[str, Any]
               ) -> Optional["MeshTensor"]:
    for x in list(args) + list(kwargs.values()):
        if isinstance(x, MeshTensor):
            return x
        if isinstance(x, (list, tuple)):
            for v in x:
                if isinstance(v, MeshTensor):
                    return v
    return None


class MeshTensor:
    """A tensor whose dimension ``axis`` is split in contiguous blocks
    over a mesh's shard devices: ``parts[d]`` is block ``d`` on the
    mesh's shard device ``d`` (replica 0), contiguous. ``copies[r]`` are
    replica r's parts (``copies[0] is parts``). See the module notes
    for which ops run part by part."""

    __slots__ = ("mesh", "parts", "axis", "copies")

    def __init__(self, mesh: MeshContext, parts: List[torch.Tensor],
                 axis: int, copies: Optional[List[List[torch.Tensor]]]
                 = None):
        self.mesh = mesh
        self.parts = list(parts) if copies is None else copies[0]
        self.axis = axis
        self.copies = copies if copies is not None else [self.parts]

    # -- metadata ------------------------------------------------------------

    @property
    def shape(self) -> torch.Size:
        sizes = list(self.parts[0].shape)
        sizes[self.axis] = sum(int(p.shape[self.axis]) for p in self.parts)
        return torch.Size(sizes)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def ndim(self) -> int:
        return self.parts[0].dim()

    @property
    def is_cuda(self) -> bool:
        return self.parts[0].is_cuda

    @property
    def nbytes(self) -> int:
        return sum(int(p.nbytes) for p in self.parts)

    def dim(self) -> int:
        return self.ndim

    def size(self, d: Optional[int] = None) -> Any:
        return self.shape if d is None else self.shape[d]

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def is_contiguous(self) -> bool:
        return all(p.is_contiguous() for p in self.parts)

    def __len__(self) -> int:
        return int(self.shape[0])

    def __repr__(self) -> str:
        return (f"MeshTensor(shape={tuple(self.shape)}, axis={self.axis}, "
                f"parts={len(self.parts)}, dtype={self.dtype})")

    # -- collectives ---------------------------------------------------------

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device (the
        all-gather)."""
        return self.mesh.all_gather(self.parts, self.axis)

    def part_of(self, other: Any, d: int) -> Any:
        """Part ``d`` of an operand combined with this tensor: a
        MeshTensor's own part, a plain tensor that spans the shard axis
        narrowed to the block, any other tensor moved to the part's
        device, a non-tensor as it is."""
        if isinstance(other, MeshTensor):
            return other.parts[d]
        if not isinstance(other, torch.Tensor):
            return other
        dev = self.parts[d].device
        pos = other.dim() + (self.axis - self.ndim)
        if pos >= 0 and int(other.shape[pos]) != 1:
            step = int(self.parts[d].shape[self.axis])
            return other.narrow(pos, d * step, step).to(dev)
        return other.to(dev)

    def _aligned(self, other: Any) -> bool:
        """Whether an operand splits as this tensor does."""
        if isinstance(other, MeshTensor):
            return (other.mesh is self.mesh
                    and other.axis - other.ndim == self.axis - self.ndim
                    and [p.shape[other.axis] for p in other.parts]
                    == [p.shape[self.axis] for p in self.parts])
        if isinstance(other, torch.Tensor):
            pos = other.dim() + (self.axis - self.ndim)
            return pos < 0 or int(other.shape[pos]) in (
                1, int(self.shape[self.axis]))
        return True

    def _wrap(self, outs: List[Any], axis: int) -> Any:
        if all(isinstance(o, torch.Tensor) for o in outs):
            return MeshTensor(self.mesh, outs, axis)
        return outs[0]

    # -- dispatch ------------------------------------------------------------

    @classmethod
    def __torch_function__(cls, func: Callable, types: Any,
                           args: Sequence[Any] = (),
                           kwargs: Optional[Dict[str, Any]] = None) -> Any:
        return _dispatch(func, tuple(args), dict(kwargs or {}))

    def __getattr__(self, name: str) -> Any:
        meth = getattr(torch.Tensor, name)
        if not callable(meth):
            return getattr(self.gather(), name)

        def call(*a: Any, **k: Any) -> Any:
            return _dispatch(meth, (self,) + a, k)
        return call

    def __getitem__(self, idx: Any) -> Any:
        return _dispatch(torch.Tensor.__getitem__, (self, idx), {})

    def __setitem__(self, idx: Any, value: Any) -> None:
        _dispatch(torch.Tensor.__setitem__, (self, idx, value), {})

    def __int__(self) -> int:
        return int(self.gather())

    def __bool__(self) -> bool:
        return bool(self.gather())

    __hash__ = object.__hash__


def _binop(name: str) -> Callable:
    meth = getattr(torch.Tensor, name)

    def op(self: MeshTensor, *a: Any) -> Any:
        return _dispatch(meth, (self,) + a, {})
    op.__name__ = name
    return op


for _name in ("__and__", "__or__", "__xor__", "__rand__", "__ror__",
              "__rxor__", "__invert__", "__lshift__", "__rshift__",
              "__iand__", "__ior__", "__ixor__", "__eq__", "__ne__",
              "__add__", "__sub__", "__mul__", "__radd__", "__rmul__",
              "__lt__", "__le__", "__gt__", "__ge__"):
    setattr(MeshTensor, _name, _binop(_name))


def _dispatch(func: Callable, args: Tuple[Any, ...],
              kwargs: Dict[str, Any]) -> Any:
    ref = _find_mesh(args, kwargs)
    name = getattr(func, "__name__", "")
    out: Any = NotImplemented
    if ref is not None:
        if name in _ELEMENTWISE:
            out = _elementwise(ref, func, name, args, kwargs)
        elif name in ("__getitem__", "__setitem__") \
                and isinstance(args[0], MeshTensor):
            out = _index(args[0], name, args[1:])
        elif name in ("unsqueeze", "index_select") \
                and isinstance(args[0], MeshTensor):
            out = _dim_op(args[0], func, args[1:], kwargs)
        elif name == "pad" and isinstance(args[0], MeshTensor):
            out = _pad(args[0], func, args[1:], kwargs)
        elif name == "reshape" and isinstance(args[0], MeshTensor):
            out = _reshape(args[0], func, args[1:])
        elif name == "to" and isinstance(args[0], MeshTensor):
            out = _to(args[0], func, args[1:], kwargs)
    if out is not NotImplemented:
        return out
    # The all-gather fallback: the op on the whole tensor. An in-place
    # op writes the gathered tensor, whose blocks then go back into the
    # parts (and their replica copies).
    if ref is not None and _is_inplace(name) \
            and isinstance(args[0], MeshTensor):
        t = args[0]
        full = t.gather()
        func(full, *_gathered(args[1:]), **_gathered(kwargs))
        step = int(t.parts[0].shape[t.axis])
        for copies in t.copies:
            for d, p in enumerate(copies):
                p.copy_(full.narrow(t.axis, d * step, step))
        return None if name == "__setitem__" else t
    return func(*_gathered(args), **_gathered(kwargs))


def _elementwise(ref: MeshTensor, func: Callable, name: str,
                 args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Any:
    operands = list(args) + list(kwargs.values())
    if not all(ref._aligned(x) for x in operands):
        return NotImplemented
    outs = []
    for d in range(len(ref.parts)):
        a = tuple(ref.part_of(x, d) for x in args)
        k = {key: ref.part_of(v, d) for key, v in kwargs.items()}
        outs.append(func(*a, **k))
    if _is_inplace(name) and isinstance(args[0], MeshTensor):
        return args[0]
    o = outs[0]
    if not isinstance(o, torch.Tensor):
        return o
    axis = o.dim() + (ref.axis - ref.ndim)
    if axis < 0:
        return NotImplemented
    return MeshTensor(ref.mesh, outs, axis)


def _index_map(t: MeshTensor, idx: Any) -> Optional[Tuple[Any, int]]:
    """(the index tuple, the result's shard axis) for an index that
    leaves the shard axis whole, else None."""
    items = idx if isinstance(idx, tuple) else (idx,)
    real = 0
    for it in items:
        if it is None or it is Ellipsis:
            continue
        if isinstance(it, torch.Tensor) and it.dtype == torch.bool:
            return None
        real += 1
    if sum(1 for it in items if it is Ellipsis) > 1:
        return None
    expanded: List[Any] = []
    for it in items:
        if it is Ellipsis:
            expanded += [slice(None)] * (t.ndim - real)
        else:
            expanded.append(it)
    dim = out_dim = 0
    new_axis = None
    advanced = 0
    for it in expanded:
        if it is None:
            out_dim += 1
            continue
        if dim == t.axis:
            if not (isinstance(it, slice) and it == slice(None)):
                return None
            new_axis = out_dim
        if isinstance(it, slice):
            out_dim += 1
        elif isinstance(it, (int,)) or (hasattr(it, "__index__")
                                        and not isinstance(
                                            it, (torch.Tensor, list))):
            pass
        elif isinstance(it, (torch.Tensor, list)):
            advanced += 1
            nd = torch.as_tensor(it).dim() if isinstance(it, list) \
                else it.dim()
            out_dim += nd
        else:
            return None
        dim += 1
    if advanced > 1 or dim > t.ndim:
        return None
    if new_axis is None:
        new_axis = out_dim + (t.axis - dim)
    return tuple(expanded), new_axis


def _index(t: MeshTensor, name: str, rest: Tuple[Any, ...]) -> Any:
    mapped = _index_map(t, rest[0])
    if mapped is None:
        return NotImplemented
    idx, new_axis = mapped

    def at(d: int) -> Tuple[Any, ...]:
        dev = t.parts[d].device
        return tuple(i.to(dev) if isinstance(i, torch.Tensor) else i
                     for i in idx)

    if name == "__getitem__":
        return MeshTensor(t.mesh, [p[at(d)] for d, p in enumerate(t.parts)],
                          new_axis)
    value = rest[1]
    # The value lines up with the indexed region, whose shard axis is
    # new_axis of the result of t[idx].
    region = MeshTensor(t.mesh, [p[at(d)] for d, p in enumerate(t.parts)],
                        new_axis)
    if not region._aligned(value):
        return NotImplemented
    for d, p in enumerate(t.parts):
        p[at(d)] = region.part_of(value, d)
    return None


def _dim_op(t: MeshTensor, func: Callable, rest: Tuple[Any, ...],
            kwargs: Dict[str, Any]) -> Any:
    name = func.__name__
    rest = list(rest)
    dim = rest.pop(0) if rest else kwargs.pop("dim")
    nd = t.ndim + (1 if name == "unsqueeze" else 0)
    dim = dim + nd if dim < 0 else dim
    if name == "unsqueeze":
        axis = t.axis + 1 if dim <= t.axis else t.axis
    else:
        if dim == t.axis:
            return NotImplemented
        axis = t.axis
    outs = []
    for p in t.parts:
        r = [x.to(p.device) if isinstance(x, torch.Tensor) else x
             for x in rest]
        outs.append(func(p, dim, *r, **kwargs))
    return MeshTensor(t.mesh, outs, axis)


def _pad(t: MeshTensor, func: Callable, rest: Tuple[Any, ...],
         kwargs: Dict[str, Any]) -> Any:
    pad = rest[0] if rest else kwargs.get("pad")
    # pad pairs run from the last dimension backwards.
    if t.ndim - 1 - t.axis < len(pad) // 2:
        return NotImplemented
    return MeshTensor(t.mesh, [func(p, *rest, **kwargs) for p in t.parts],
                      t.axis)


def _reshape(t: MeshTensor, func: Callable, rest: Tuple[Any, ...]) -> Any:
    """A reshape that keeps the shard axis and every dimension after it
    (merging or splitting only the leading ones) runs part by part."""
    shape = list(rest[0]) if len(rest) == 1 and isinstance(
        rest[0], (tuple, list, torch.Size)) else list(rest)
    tail = list(t.shape[t.axis:])
    k = len(tail)
    if len(shape) < k or [int(x) for x in shape[len(shape) - k:]] != tail:
        return NotImplemented
    axis = len(shape) - k
    outs = []
    for p in t.parts:
        local = shape[:axis] + list(p.shape[t.axis:])
        outs.append(func(p, local))
    return MeshTensor(t.mesh, outs, axis)


def _to(t: MeshTensor, func: Callable, rest: Tuple[Any, ...],
        kwargs: Dict[str, Any]) -> Any:
    """``to`` a dtype runs part by part; ``to`` the mesh's own device
    type keeps the parts where they are; any other device gathers."""
    dev = kwargs.get("device")
    dtype = kwargs.get("dtype")
    for x in rest:
        if isinstance(x, torch.dtype):
            dtype = x
        elif isinstance(x, (str, torch.device)):
            dev = x
        elif x is not None:
            return NotImplemented
    if dev is not None and torch.device(dev).type != t.mesh.device.type:
        return NotImplemented
    if dtype is None:
        return t
    return MeshTensor(t.mesh, [p.to(dtype) for p in t.parts], t.axis)


def split_like(ref: MeshTensor, other: Union[MeshTensor, torch.Tensor]
               ) -> List[torch.Tensor]:
    """``other``'s parts, aligned to ``ref``'s (split when plain)."""
    return [ref.part_of(other, d) for d in range(len(ref.parts))]
