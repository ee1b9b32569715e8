"""Roofline of a cell on one NVIDIA H100, from counts taken on the meta
device.

Twin of ``src/repro/launch/roofline.py``. Three terms per cell, in
seconds:

    compute    = FLOPs in bf16 / 989 TFLOP/s + other FLOPs / 67 TFLOP/s
    memory     = bytes / 3.35 TB/s
    collective = collective bytes / 900 GB/s (NVLink; 0 on one card;
                 an all-reduce's bytes counted twice)

The rates are the H100 SXM5 data sheet's (dense, no sparsity, at the 700 W
limit): bf16 on the tensor cores, float32 outside them (the port keeps
TF32 off where a float32 product feeds a decision or a tolerance), HBM3
and NVLink 4.

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` of the
compiled program and collective bytes from its HLO text (``cost_dict``,
``from_compiled``, ``collective_bytes``). Eager PyTorch compiles nothing,
so those have no twin; ``from_counts`` takes their place, fed by a
``Reckoner`` and, under a mesh, by the collective wrappers' own count of
their output bytes (``dist/collectives.py::counting``, the reference's
output-shape proxy): the step traced once on the meta device, which
allocates nothing, counting

* FLOPs op by op with ``torch.utils.flop_counter``'s registry (the counts
  ``FlopCounterMode`` gives), split by the dtype of the op's first
  floating input; a kernel's entry point is one op on the meta device
  (``kernels/ops.py``), counted at the kernel's own work (flash's causal
  half);
* the peak of the bytes the step holds beyond its arguments, from the
  storages its ops allocate and free (a kernel's op allocates its outputs
  only).

Bytes are what the step must move at least: each argument storage it
reads, once, and each output storage, once. A gather (``index_select``,
indexing by a tensor, ``embedding``, ``gather``, ``take``) reads only the
rows it returns, so an embedding table counts the bytes its lookups
return (at most the table), not the whole table, unless another op reads
it whole.

``model_flops`` (the "useful work" yardstick) is the reference's
arithmetic over the port's own configs: 6*N*D for dense training,
6*N_active*D for MoE, 2*N*D for forward-only serving, attention FLOPs
added explicitly.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.collectives import KINDS

# H100 SXM5 data sheet: dense peaks at the 700 W limit
PEAK_FLOPS_BF16 = 989e12      # tensor cores, bf16 (and fp16) inputs
PEAK_FLOPS_F32 = 67e12        # float32 outside the tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
LINK_BW = 900e9               # B/s, NVLink 4, per GPU
HBM_BYTES = 80 * 2 ** 30      # the card's 80 GB
_TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)

# ops that read only the rows they return from their first input
_GATHERS = (torch.ops.aten.index_select, torch.ops.aten.index,
            torch.ops.aten.embedding, torch.ops.aten.gather,
            torch.ops.aten.take)

_COLLECTIVES = KINDS         # the reference's kinds, as the wrappers count


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    coll_bytes: dict             # per device, by kind
    peak_memory: float           # per device, bytes
    tensor_core_flops: float = 0.0   # the part of ``flops`` in bf16/fp16

    @property
    def compute_s(self) -> float:
        return (self.tensor_core_flops / PEAK_FLOPS_BF16
                + (self.flops - self.tensor_core_flops) / PEAK_FLOPS_F32)

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        # ring all-reduce moves ~2x its payload (reduce-scatter+all-gather)
        b = sum(v * (2 if k == "all-reduce" else 1)
                for k, v in self.coll_bytes.items())
        return b / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "flops_tensor_core_per_dev": self.tensor_core_flops,
            "bytes_per_dev": self.bytes_accessed,
            "coll_bytes_per_dev": self.coll_bytes,
            "peak_memory_per_dev": self.peak_memory,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def from_counts(flops: float, bytes_accessed: float, peak_memory: float, *,
                tensor_core_flops: float = 0.0,
                coll_bytes: dict | None = None) -> Roofline:
    """A device's roofline from a ``Reckoner``'s counts and the output
    bytes of its collectives by kind (``dist/collectives.py::counting``;
    none on one device), in place of the reference's
    ``from_compiled``."""
    coll_bytes = coll_bytes or {}
    return Roofline(flops=float(flops), bytes_accessed=float(bytes_accessed),
                    coll_bytes={k: coll_bytes.get(k, 0)
                                for k in _COLLECTIVES},
                    peak_memory=float(peak_memory),
                    tensor_core_flops=float(tensor_core_flops))


def tensors_of(obj) -> list[torch.Tensor]:
    """The tensors of a nest of modules (parameters and buffers), dicts,
    lists, tuples and tensors, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in tensors_of(o)]
    return []


def storage_bytes(obj, exclude=()) -> int:
    """Bytes of the distinct storages of ``obj``'s tensors, leaving out
    those of ``exclude``'s."""
    skip = {StorageWeakRef(t.untyped_storage()).cdata
            for t in tensors_of(exclude)}
    seen = {}
    for t in tensors_of(obj):
        st = t.untyped_storage()
        cd = StorageWeakRef(st).cdata
        if cd not in skip:
            seen[cd] = st.nbytes()
    return sum(seen.values())


class Reckoner(TorchDispatchMode):
    """Counts a step traced under it on the meta device: FLOPs (the
    ``FlopCounterMode`` registry's, by the dtype of each op's first
    input), the bytes of ``args`` it reads (``bytes_read``), and the peak
    of the bytes allocated beyond ``args``, each storage counted from the
    op that made it until it is freed (autograd's saved tensors
    included).

        with Reckoner(args) as r:
            out = step(*args)
        r.flops, r.tensor_core_flops, r.bytes_read, r.peak_bytes
    """

    def __init__(self, args):
        super().__init__()
        self._args = {StorageWeakRef(t.untyped_storage()).cdata:
                      t.untyped_storage().nbytes() for t in tensors_of(args)}
        self._read: set[int] = set()          # argument storages read whole
        self._gathered: dict[int, int] = {}   # bytes gathered from the rest
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.flops = 0
        self.tensor_core_flops = 0

    def _sweep(self) -> None:
        expired = torch.UntypedStorage._expired
        for cd in [cd for cd in self._live if expired(cd)]:
            self.live_bytes -= self._live.pop(cd)[1]

    def _add(self, cd: int, ref: StorageWeakRef, n: int) -> None:
        self._live[cd] = (ref, n)
        self.live_bytes += n
        # freed storages are swept only when the count would pass the
        # peak: before that, what they inflate cannot raise it
        if self.live_bytes > self.peak_bytes:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _note(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage if the step just made it. A weak
        reference keeps a storage's address from reuse, so an address
        seen before is the same storage."""
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        cd = ref.cdata
        if cd in self._args or cd in self._live:
            return
        self._add(cd, ref, st.nbytes())

    @property
    def bytes_read(self) -> int:
        """Bytes of the arguments the step read: each storage read whole
        once, and from the others the rows gathered, at most the
        storage."""
        return (sum(self._args[cd] for cd in self._read)
                + sum(min(n, self._args[cd])
                      for cd, n in self._gathered.items()
                      if cd not in self._read))

    def _note_reads(self, func, args, out) -> None:
        gather = func._overloadpacket in _GATHERS
        for i, t in enumerate(tensors_of(list(args))):
            cd = StorageWeakRef(t.untyped_storage()).cdata
            if cd not in self._args:
                continue
            if gather and i == 0:
                self._gathered[cd] = (self._gathered.get(cd, 0)
                                      + out.numel() * out.element_size())
            else:
                self._read.add(cd)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._note_reads(func, args, out)
        count = flop_registry.get(func._overloadpacket)
        if func._overloadpacket is torch.ops.aten.mv:   # not registered
            count = lambda m, v, out_val: 2 * m.numel()  # noqa: E731
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            self.flops += n
            dtype = next((t.dtype for t in tensors_of(list(args))
                          if t.is_floating_point()), None)
            if dtype in _TENSOR_CORE_DTYPES:
                self.tensor_core_flops += n
        for t in tensors_of(out if isinstance(out, (list, tuple))
                            else [out]):
            self._note(t)
        return out


def model_flops(arch_id: str, shape_name: str,
                cut: dict | None = None) -> float:
    """Analytic 'useful' FLOPs per step (``roofline.py:141-217``), over the
    port's configs; ``cut`` overrides shape dims (and ``n_layers``) as a
    cell's cut does."""
    from repro_torch.configs import base as cfg_base
    arch = cfg_base.get(arch_id)
    shape = arch.shape(shape_name)
    cut = dict(cut or {})
    n_layers = cut.pop("n_layers", None)
    dims = {**shape.dims, **cut}
    cfg = arch.make_config()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)

    if arch.family == "lm":
        n_act = cfg.n_active_params
        s, b = dims["seq_len"], dims["global_batch"]
        if shape.kind == "train":
            tokens = s * b
            attn = (6 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim
                    * s * s // 2 * b)     # fwd+bwd causal attention
            return 6.0 * n_act * tokens + attn
        if shape.kind == "prefill":
            tokens = s * b
            attn = 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim \
                * s * s // 2 * b
            return 2.0 * n_act * tokens + attn
        # decode: one token/seq; attention reads the whole cache
        attn = 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.head_dim * s * b
        return 2.0 * n_act * b + attn

    if arch.family == "gnn":
        e, d = dims["n_edges"], dims["d_feat"]
        n = dims["n_nodes"]
        h, dh = cfg.n_heads, cfg.d_hidden
        # per layer: projection 2*N*d_in*H*Dh + edge ops ~ 2*E*H*(Dh+2)
        l1 = 2 * n * d * h * dh + 4 * e * h * dh
        l2 = 2 * n * h * dh * dims["n_classes"] + 4 * e * dims["n_classes"]
        fwd = l1 + l2
        return 3.0 * fwd if shape.kind == "train" else fwd

    # recsys
    b = dims.get("batch", dims.get("n_candidates", 1))
    if arch.arch_id in ("deepfm", "xdeepfm"):
        f, d = cfg.embedding.n_fields, cfg.embedding.dim
        mlp_dims = (f * d,) + cfg.mlp_dims + (1,)
        mlp = sum(2 * a * bb for a, bb in zip(mlp_dims[:-1], mlp_dims[1:]))
        inter = 2 * f * d
        if cfg.interaction == "cin":
            sizes = (f,) + cfg.cin_layers
            inter = sum(2 * sizes[i] * f * sizes[i + 1] * d
                        for i in range(len(cfg.cin_layers)))
        fwd = b * (mlp + inter)
    elif arch.arch_id == "din":
        d = cfg.embedding.dim
        attn_dims = (4 * d,) + cfg.attn_mlp + (1,)
        attn = cfg.seq_len * sum(2 * a * bb for a, bb in
                                 zip(attn_dims[:-1], attn_dims[1:]))
        mlp_in = (2 + cfg.embedding.n_fields - 1) * d
        mlp_dims = (mlp_in,) + cfg.mlp_dims + (1,)
        mlp = sum(2 * a * bb for a, bb in zip(mlp_dims[:-1], mlp_dims[1:]))
        fwd = b * (attn + mlp)
    else:  # two-tower
        du = cfg.user_embedding.n_fields * cfg.user_embedding.dim
        di = cfg.item_embedding.n_fields * cfg.item_embedding.dim
        dims_u = (du,) + cfg.tower_dims + (cfg.out_dim,)
        dims_i = (di,) + cfg.tower_dims + (cfg.out_dim,)
        tower = sum(2 * a * bb for a, bb in zip(dims_u[:-1], dims_u[1:])) + \
            sum(2 * a * bb for a, bb in zip(dims_i[:-1], dims_i[1:]))
        if shape.kind == "retrieval":
            n = dims["n_candidates"]
            du_only = sum(2 * a * bb for a, bb in
                          zip(dims_u[:-1], dims_u[1:]))
            return du_only + 2.0 * n * cfg.out_dim
        if shape.kind == "train":
            fwd = b * tower + 2 * b * b * cfg.out_dim
            return 3.0 * fwd
        fwd = b * tower + 2 * b * cfg.out_dim
        return fwd
    return 3.0 * fwd if shape.kind == "train" else fwd
