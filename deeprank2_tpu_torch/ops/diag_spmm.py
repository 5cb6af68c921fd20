"""Graph-diagonal aggregation (port of ``deeprank2_tpu/ops/diag_spmm.py``).

A collated :class:`~deeprank2_tpu_torch.ops.batch.DenseGraphBatch` has a
block-diagonal adjacency: graph ``g`` owns columns ``[g*N, (g+1)*N)`` of the
flat transposed activations ``[F, G*N]``, and the aggregation is, per graph,

    out[f, g*N + i] = sum_j adj[g, i, j] * x[f, g*N + j]

(the oracle ``diag_spmm_t_xla``), with ``adj`` int8 0/1, or bf16 or f32
edge weights (sGAT; the JAX package sends its f32 "exact oracle" adjacency
to XLA instead of its kernel, the port has no fallback and computes the same
function in its kernel). ``compute_dtype=torch.bfloat16`` selects the
single-pass bf16 form of each kernel (the JAX ``split=False`` branch): the
activations are rounded to bf16 once, the adjacency is taken as bf16 (exact
for int8 0/1 and bf16 weights; an f32 adjacency has no bf16 form, as JAX's
kernel never takes one: :func:`diag_spmm_t` computes JAX's XLA fallback for
it instead), and the products accumulate in f32. The default is
the f32 form, exact up to summation order. It runs in the CUDA kernels of
``csrc/diag_spmm.cu``: ``diag_kernel`` (plain, relu/mask epilogue, or
relu/mask plus per-graph sum pool) and ``pool_bwd_kernel`` (the pooled
layer's backward). Two bodies run them there, and :func:`diag_body` picks
one by form: ``"mma"`` (tensor cores, ``mma.sync``, bf16 operands, f32
sums: every form on an int8 or bf16 adjacency; the bf16 forms in one pass,
``diag_kernel``'s f32 form over the three exact bf16 pieces of each
activation (:func:`split3`), and ``pool_bwd_kernel`` as a count product,
``g_pool`` added ``(A @ sign)[f, i]`` times) and ``"fma"`` (f32 FMAs on
CUDA cores in ascending node order: every form on an f32 adjacency, which
the tensor-core body does not take).
Edges are mirrored, so ``A^T = A`` per graph and each VJP is the same
aggregation applied to the cotangent.

:func:`tower_pooled` fuses the whole two-layer tower with its per-graph sum
pool into one forward and one backward kernel (``csrc/diag_tower.cu``:
``tower_fwd_kernel`` and ``tower_bwd_kernel``), which read the adjacency
once per direction (int8 adjacency only), in an f32 and a bf16 form (the
JAX ``split=False`` branch: ``x_t``, the weights, ``fcx1``, ``h1``,
``fcx2``, then ``u2``, ``t2`` and ``u1`` rounded to bf16 once, in the
kernel; ``t2`` and ``t1`` returned as bf16). The forward runs on the plan
and steps of the batched tower's forward (``ops/ginet_tower.py``). The
backward takes ``t2 = A (sign ⊙ g_pool)`` as ``g_pool`` times the count of
each node's neighbours whose sign is set: the exact sum rounded once (in
the bf16 form exact, the plain version's value). :func:`tower_supports` is
the flat tower's shape rule (:func:`tower_fwd_smem_bytes` and
:func:`tower_bwd_smem_bytes` mirror the kernels' shared-memory plans).

Each kernel wrapper takes its plain PyTorch version (``*_ref``) for tensors
on the CPU, launches its kernel for tensors on a CUDA device, and raises for
anything else; each counts its kernel launches in :data:`launches`, and by
form in :data:`launches_by_dtype`, keyed ``"<adjacency type>/<activation
type>"`` (``"int8/bfloat16"``, ...).
"""

from __future__ import annotations

import ctypes

import torch

from deeprank2_tpu_torch.ops import _build
from deeprank2_tpu_torch.ops.tower_plan import SMEM_LIMIT, plan_bytes, round16, row_bytes

SOURCE = "diag_spmm"
TOWER_SOURCE = "diag_tower"
MODES = {"plain": 0, "relu_mask": 1, "relu_mask_pool": 2}
# the adjacency types K1 and K2 take, by their code in csrc/diag_spmm.cu
ADJ_DTYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# the activation types of the kernels' two forms (f32, and single-pass
# bf16), by their code in the CUDA sources
ACT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_name(dtype: torch.dtype) -> str:
    """``"int8"``, ``"bfloat16"``, ...: the name of a type in a form's key."""
    return str(dtype).removeprefix("torch.")


def form_name(storage: torch.dtype, act: torch.dtype) -> str:
    """``"int8/bfloat16"``: the key of a kernel form in ``launches_by_dtype``,
    the adjacency (or block) type, then the activation type."""
    return f"{dtype_name(storage)}/{dtype_name(act)}"


def activation_dtype(compute_dtype: torch.dtype | None) -> torch.dtype:
    """The activation type of the kernel form that ``compute_dtype`` selects:
    float32 for None or float32 (the f32 form), bfloat16 for bfloat16 (the
    single-pass bf16 form). Anything else raises ``ValueError``."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return torch.float32
    if compute_dtype == torch.bfloat16:
        return torch.bfloat16
    msg = f"compute_dtype must be None, torch.float32 or torch.bfloat16, got {compute_dtype}"
    raise ValueError(msg)


def round_to(x: torch.Tensor, act: torch.dtype) -> torch.Tensor:
    """The values the form of activation type ``act`` computes with: ``x``
    itself for float32; for bfloat16, ``x`` rounded to bf16 (nearest even)
    and widened to f32 exactly."""
    return x if act == torch.float32 else x.to(act).float()


# K1 and K2 forms: every adjacency type in the f32 form, int8 and bf16 in the bf16 form
FORMS = [(a, torch.float32) for a in ADJ_DTYPES] + [(a, torch.bfloat16) for a in (torch.int8, torch.bfloat16)]
# K9f and K9b forms: the int8 adjacency, both activation types
TOWER_FORMS = [(torch.int8, a) for a in ACT_DTYPES]

# the two bodies of K1 and K2 in csrc/diag_spmm.cu, by their code there:
# tensor cores (int8 and bf16 adjacencies), and f32 FMAs on CUDA cores (every
# form; the only body of an f32 adjacency)
BODIES = {"mma": 0, "fma": 1}


def diag_body(kernel: str, adj_dtype: torch.dtype, act_dtype: torch.dtype) -> str:
    """The body of ``csrc/diag_spmm.cu`` that runs ``kernel``
    (``"diag_kernel"`` or ``"pool_bwd_kernel"``) in the form (``adj_dtype``,
    ``act_dtype``) on the card: ``"fma"`` for every form on an f32 adjacency
    (the tensor-core body takes none), ``"mma"`` for every form on an int8
    or bf16 one. The wrappers hand it to the kernel, so this is the one
    place the split is made; no other choice is made at run time."""
    if kernel not in ("diag_kernel", "pool_bwd_kernel"):
        msg = f"kernel must be 'diag_kernel' or 'pool_bwd_kernel', got {kernel!r}"
        raise ValueError(msg)
    if (adj_dtype, act_dtype) not in FORMS:
        msg = f"(adj_dtype, act_dtype) must be one of {FORMS}, got {(adj_dtype, act_dtype)}"
        raise TypeError(msg)
    return "fma" if adj_dtype == torch.float32 else "mma"

# kernel launches since the last reset_launches(), by kernel and by form
launches = {"diag_kernel": 0, "pool_bwd_kernel": 0, "tower_fwd_kernel": 0, "tower_bwd_kernel": 0}
launches_by_dtype = {
    **{k: {form_name(*f): 0 for f in FORMS} for k in ("diag_kernel", "pool_bwd_kernel")},
    **{k: {form_name(*f): 0 for f in TOWER_FORMS} for k in ("tower_fwd_kernel", "tower_bwd_kernel")},
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for forms in launches_by_dtype.values():
        for form in forms:
            forms[form] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library(SOURCE)
    if lib.diag_kernel.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.diag_kernel.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i, p]
        lib.diag_kernel.restype = i
        lib.pool_bwd_kernel.argtypes = [p, i, p, p, i, p, i, i, i, i, p]
        lib.pool_bwd_kernel.restype = i
        lib.diag_max_nodes.argtypes = [i, i]
        lib.diag_max_nodes.restype = i
    return lib


def _tower_lib() -> ctypes.CDLL:
    lib = _build.library(TOWER_SOURCE)
    if lib.tower_fwd_kernel.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tower_fwd_kernel.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.tower_fwd_kernel.restype = i
        lib.tower_bwd_kernel.argtypes = [p, p, p, p, p, i, p, p, i, i, i, i, p]
        lib.tower_bwd_kernel.restype = i
    return lib


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if t.dtype != dtype:
        msg = f"{name} must be {dtype}, got {t.dtype}"
        raise TypeError(msg)
    if tuple(t.shape) != shape:
        msg = f"{name} must have shape {shape}, got {tuple(t.shape)}"
        raise ValueError(msg)
    if t.device != device:
        msg = f"{name} is on {t.device}, expected {device}"
        raise ValueError(msg)
    if not t.is_contiguous():
        msg = f"{name} must be contiguous"
        raise ValueError(msg)


def _dims(adj: torch.Tensor, x_t: torch.Tensor, dtypes=ADJ_DTYPES) -> tuple[int, int, int]:
    """``(G, N, F)`` of an adjacency ``[G, N, N]`` of one of ``dtypes`` and
    activations ``[F, G*N]`` on the same device."""
    if adj.dim() != 3 or x_t.dim() != 2:
        msg = f"expected adj [G, N, N] and x_t [F, G*N], got {tuple(adj.shape)} and {tuple(x_t.shape)}"
        raise ValueError(msg)
    if adj.dtype not in dtypes:
        msg = f"adj must be one of {tuple(dtypes)}, got {adj.dtype}"
        raise TypeError(msg)
    g, n, _ = adj.shape
    _require(adj, "adj", adj.dtype, (g, n, n), x_t.device)
    return g, n, x_t.shape[0]


def _form(adj: torch.Tensor, compute_dtype: torch.dtype | None) -> torch.dtype:
    """The activation type of the form that runs ``adj`` under ``compute_dtype``."""
    act = activation_dtype(compute_dtype)
    if (adj.dtype, act) not in FORMS:
        msg = f"the bf16 form takes an int8 or bf16 adjacency, got {adj.dtype} (JAX sends an f32 one to XLA)"
        raise TypeError(msg)
    return act


def _operand(x: torch.Tensor, name: str, act: torch.dtype, shape: tuple, device: torch.device) -> torch.Tensor:
    """An f32 activation operand (or a bf16 one, for the bf16 form) as the
    kernel form ``act`` reads it: itself, or its bf16 copy (half the bytes)."""
    if x.dtype not in (torch.float32, act):
        msg = f"{name} must be {torch.float32}" + ("" if act == torch.float32 else f" or {act}") + f", got {x.dtype}"
        raise TypeError(msg)
    _require(x, name, x.dtype, shape, device)
    return x.to(act)


def _route(device: torch.device) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    msg = f"no kernel or plain version for device {device}"
    raise ValueError(msg)


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 pieces of f32 ``x`` that K1's f32 form on an int8 or
    bf16 adjacency multiplies on the tensor cores: ``hi`` is ``x`` cut to its top 8
    significant bits (bf16 toward zero), ``mid`` the same of ``x - hi``, and
    ``lo = x - hi - mid``. 8 + 8 + 8 significant bits hold f32's 24 and each
    remainder is exact in f32, so ``hi + mid + lo == x`` (summed in f32), and
    a piece times an int8 0/1 entry or a bf16 weight is exact in f32. (A
    zero's pieces are zeros, ``hi`` with its sign.)"""
    r = x.float()
    pieces = []
    for _ in range(3):
        piece = (r.view(torch.int32) & -65536).view(torch.float32)  # the top 16 bits
        pieces.append(piece.to(torch.bfloat16))
        r = r - piece
    return pieces[0], pieces[1], pieces[2]


# ---------------------------------------------------------------------------
# K1: diag_kernel (replaces deeprank2_tpu/ops/diag_spmm.py:_diag_kernel)


def diag_kernel_ref(adj: torch.Tensor, x_t: torch.Tensor, mask: torch.Tensor | None = None, mode: str = "plain", compute_dtype=None):
    """Plain PyTorch version of :func:`diag_kernel` (same arguments and
    results): the bf16 form rounds ``x_t`` to bf16 and sums in f32."""
    g, n, _ = adj.shape
    f = x_t.shape[0]
    x = round_to(x_t, _form(adj, compute_dtype))
    out = torch.einsum("fgj,gij->fgi", x.reshape(f, g, n), adj.to(x.dtype)).reshape(f, g * n)
    if mode == "plain":
        return out
    h = torch.relu(out) * mask.reshape(1, g * n).to(out.dtype)
    if mode == "relu_mask":
        return h
    return (h > 0).to(torch.uint8), h.reshape(f, g, n).sum(dim=2)


def _count(kernel: str, adj: torch.Tensor, act: torch.dtype) -> None:
    launches[kernel] += 1
    launches_by_dtype[kernel][form_name(adj.dtype, act)] += 1


def diag_kernel(adj: torch.Tensor, x_t: torch.Tensor, mask: torch.Tensor | None = None, mode: str = "plain", compute_dtype=None):
    """Per-graph aggregation of ``x_t [F, G*N]`` (f32) by ``adj [G, N, N]``
    (int8 0/1, or bf16 or f32 weights, each taken at its exact f32 value).
    ``compute_dtype=torch.bfloat16`` runs the bf16 form (``x_t`` f32 or
    bf16, rounded to bf16; int8 or bf16 adjacency); the result is f32. On
    the card the body :func:`diag_body` names runs it: the bf16 forms on the
    tensor cores in one pass, the f32 form on an int8 or bf16 adjacency in
    three over :func:`split3`'s pieces, the f32 adjacency as f32 FMAs in
    ascending node order. Every form is its plain version up to the
    order of the f32 sums (the tensor cores truncate within each window of
    16 products: see ``csrc/diag_spmm.cu``).

    ``mode="plain"`` returns the aggregate ``[F, G*N]``; ``"relu_mask"``
    returns ``relu(aggregate) * mask`` (``mask [G, N]`` bool);
    ``"relu_mask_pool"`` returns ``(sign, pooled)``: ``sign [F, G*N]`` uint8
    is ``h > 0`` for ``h = relu(aggregate) * mask``, and ``pooled [F, G]``
    is ``h`` summed over each graph's nodes."""
    if mode not in MODES:
        msg = f"unknown mode {mode!r}; expected one of {sorted(MODES)}"
        raise ValueError(msg)
    g, n, f = _dims(adj, x_t)
    dev = x_t.device
    act = _form(adj, compute_dtype)
    x_t = _operand(x_t, "x_t", act, (f, g * n), dev)
    if mode != "plain":
        _require(mask, "mask", torch.bool, (g, n), dev)
    if not _route(dev):
        return diag_kernel_ref(adj, x_t, mask, mode, act)
    lib = _lib()
    with torch.cuda.device(dev):
        if mode == "relu_mask_pool":
            out = None
            sign = torch.empty((f, g * n), dtype=torch.uint8, device=dev)
            pooled = torch.empty((f, g), dtype=torch.float32, device=dev)
        else:
            out = torch.empty((f, g * n), dtype=torch.float32, device=dev)
            sign = pooled = None
        code = lib.diag_kernel(
            adj.data_ptr(),
            ADJ_DTYPES[adj.dtype],
            x_t.data_ptr(),
            ACT_DTYPES[act],
            None if mask is None else mask.data_ptr(),
            None if out is None else out.data_ptr(),
            None if sign is None else sign.data_ptr(),
            None if pooled is None else pooled.data_ptr(),
            g,
            n,
            f,
            MODES[mode],
            BODIES[diag_body("diag_kernel", adj.dtype, act)],
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "diag_kernel")
    _count("diag_kernel", adj, act)
    return (sign, pooled) if mode == "relu_mask_pool" else out


def max_nodes(adj_dtype: torch.dtype, device: str | torch.device = "cuda", act_dtype: torch.dtype = torch.float32) -> int:
    """The largest N (nodes per graph) for which K1 and K2 run on ``device``
    in the form of (``adj_dtype``, ``act_dtype``): its shared memory per
    block, with the opt-in, less the kernel's static tile, over the bytes of
    one node's staged features (staged as f32 in both forms). Beyond it the
    wrappers raise."""
    if (adj_dtype, act_dtype) not in FORMS:
        msg = f"(adj_dtype, act_dtype) must be one of {FORMS}, got {(adj_dtype, act_dtype)}"
        raise TypeError(msg)
    lib = _lib()
    with torch.cuda.device(torch.device(device)):
        n = lib.diag_max_nodes(ADJ_DTYPES[adj_dtype], ACT_DTYPES[act_dtype])
    if n < 0:
        msg = "diag_max_nodes failed: the device's shared-memory limit could not be read"
        raise RuntimeError(msg)
    return n


# ---------------------------------------------------------------------------
# K2: pool_bwd_kernel (replaces deeprank2_tpu/ops/diag_spmm.py:_pool_bwd_kernel)


def pool_bwd_kernel_ref(adj: torch.Tensor, sign: torch.Tensor, g_pool: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`pool_bwd_kernel`: the bf16 form rounds
    ``u = where(sign, g_pool column, 0)`` to bf16 (JAX's
    ``_pool_bwd_kernel``, branch ``split=False``)."""
    n = adj.shape[1]
    g_pool = round_to(g_pool, _form(adj, compute_dtype))
    u = g_pool.repeat_interleave(n, dim=1) * sign.to(g_pool.dtype)
    return diag_kernel_ref(adj, u)


def pool_bwd_kernel(adj: torch.Tensor, sign: torch.Tensor, g_pool: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``d fcx = A @ (sign ⊙ broadcast(g_pool))``: the backward of the pooled
    layer, with ``sign [F, G*N]`` uint8 from :func:`diag_kernel`'s pool mode
    and the cotangent ``g_pool [F, G]`` (f32; rounded to bf16 in the bf16
    form) broadcast over each graph's nodes inside the kernel; ``adj`` and
    ``compute_dtype`` as for :func:`diag_kernel`. On an int8 or bf16
    adjacency the card computes it as a count product: ``(A @ sign)[f, i]``
    in one tensor-core pass (exact integers on an int8 adjacency; then
    ``g_pool[f, g]`` added that many times in f32, the ascending sum over
    the row bit for bit on a 0/1 adjacency, or times the count where it is
    negative), or scaled by ``g_pool[f, g]`` on bf16 weights."""
    g, n, f = _dims(adj, sign)
    dev = sign.device
    act = _form(adj, compute_dtype)
    _require(sign, "sign", torch.uint8, (f, g * n), dev)
    g_pool = _operand(g_pool, "g_pool", act, (f, g), dev)
    if not _route(dev):
        return pool_bwd_kernel_ref(adj, sign, g_pool, act)
    lib = _lib()
    with torch.cuda.device(dev):
        out = torch.empty((f, g * n), dtype=torch.float32, device=dev)
        code = lib.pool_bwd_kernel(
            adj.data_ptr(), ADJ_DTYPES[adj.dtype], sign.data_ptr(), g_pool.data_ptr(), ACT_DTYPES[act], out.data_ptr(), g, n, f,
            BODIES[diag_body("pool_bwd_kernel", adj.dtype, act)], torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "pool_bwd_kernel")
    _count("pool_bwd_kernel", adj, act)
    return out


# ---------------------------------------------------------------------------
# Differentiable layers (the JAX package's custom_vjp functions)


# The VJPs below run the forward's kernel form on the cotangent (the bf16
# form rounds it to bf16 in the kernel) and return it in f32, as the JAX
# custom-VJP rules do, whatever the primal's type.


def _xla_fallback(adj: torch.Tensor, compute_dtype: torch.dtype | None) -> bool:
    """Whether :func:`diag_spmm_t` takes JAX's XLA fallback for this
    adjacency and form: an f32 adjacency under bf16, which JAX's kernel never
    takes (``supports`` is False for 4-byte entries). There JAX casts the
    adjacency and x to bf16, sums in f32 and rounds the output to bf16
    (``diag_spmm_t_xla`` on bf16 operands), returned as f32; the port
    computes that function with K1's bf16 form on the adjacency rounded to
    bf16, and rounds K1's output."""
    return adj.dtype == torch.float32 and activation_dtype(compute_dtype) == torch.bfloat16


def _aggregate(adj: torch.Tensor, x_t: torch.Tensor, compute_dtype, rounded: bool) -> torch.Tensor:
    out = diag_kernel(adj, x_t, compute_dtype=compute_dtype)
    return round_to(out, torch.bfloat16) if rounded else out


class _DiagSpmmT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_t, adj, compute_dtype):
        ctx.rounded = _xla_fallback(adj, compute_dtype)
        if ctx.rounded:
            adj = adj.to(torch.bfloat16)
        ctx.save_for_backward(adj)
        ctx.compute_dtype = compute_dtype
        return _aggregate(adj, x_t, compute_dtype, ctx.rounded)

    @staticmethod
    def backward(ctx, grad):
        (adj,) = ctx.saved_tensors
        return _aggregate(adj, grad.contiguous(), ctx.compute_dtype, ctx.rounded), None, None


class _DiagLayerT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fcx_t, adj, node_mask, compute_dtype):
        h = diag_kernel(adj, fcx_t, node_mask, "relu_mask", compute_dtype)
        ctx.save_for_backward(adj, h)
        ctx.compute_dtype = compute_dtype
        return h

    @staticmethod
    def backward(ctx, grad):
        adj, h = ctx.saved_tensors
        # the output is its own relu mask; masked columns are 0 and drop too
        u = grad * (h > 0).to(grad.dtype)
        return diag_kernel(adj, u.contiguous(), compute_dtype=ctx.compute_dtype), None, None, None


class _DiagLayerPoolT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fcx_t, adj, node_mask, compute_dtype):
        sign, pooled = diag_kernel(adj, fcx_t, node_mask, "relu_mask_pool", compute_dtype)
        ctx.save_for_backward(adj, sign)
        ctx.compute_dtype = compute_dtype
        return pooled

    @staticmethod
    def backward(ctx, grad):
        adj, sign = ctx.saved_tensors
        return pool_bwd_kernel(adj, sign, grad.contiguous(), ctx.compute_dtype), None, None, None


def diag_spmm_t(adj: torch.Tensor, x_t: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``[F, G*N] -> [F, G*N]`` symmetric per-graph aggregation by an int8,
    bf16 or f32 adjacency, differentiable w.r.t. ``x_t`` (VJP = the same
    aggregation of the cotangent), in the kernel form ``compute_dtype``
    selects (see :func:`diag_kernel`). Under bf16 an f32 adjacency gives
    JAX's XLA fallback: rounded to bf16 with x, f32 sums, the output rounded
    to bf16 (returned as f32), forward and VJP alike."""
    return _DiagSpmmT.apply(x_t, adj, compute_dtype)


def diag_spmm_t_ref(adj: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`diag_spmm_t` (autograd through einsum)."""
    return diag_kernel_ref(adj, x_t)


def diag_layer_t(adj: torch.Tensor, node_mask: torch.Tensor, fcx_t: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``relu(mask ⊙ (fcx_t @ A))`` with the relu and mask fused into the
    kernel. VJP: ``d fcx = A @ (g ⊙ [h > 0])``. ``compute_dtype`` as for
    :func:`diag_kernel`."""
    return _DiagLayerT.apply(fcx_t, adj, node_mask, compute_dtype)


def diag_layer_t_ref(adj: torch.Tensor, node_mask: torch.Tensor, fcx_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`diag_layer_t`."""
    return diag_kernel_ref(adj, fcx_t, node_mask, "relu_mask")


def diag_layer_pool_t(adj: torch.Tensor, node_mask: torch.Tensor, fcx_t: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Final conv layer plus per-graph SUM pool in one kernel:
    ``pooled[c, g] = Σ_v relu(mask ⊙ (fcx_t @ A))[c, v in graph g]`` (``[F, G]``;
    divide by node counts outside for the mean). The backward broadcasts the
    ``[F, G]`` cotangent inside :func:`pool_bwd_kernel`. ``compute_dtype``
    as for :func:`diag_kernel`."""
    return _DiagLayerPoolT.apply(fcx_t, adj, node_mask, compute_dtype)


def diag_layer_pool_t_ref(adj: torch.Tensor, node_mask: torch.Tensor, fcx_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`diag_layer_pool_t`."""
    g, n, _ = adj.shape
    return diag_layer_t_ref(adj, node_mask, fcx_t).reshape(fcx_t.shape[0], g, n).sum(dim=2)


# ---------------------------------------------------------------------------
# The fused tower's shape rule


def tower_fwd_smem_bytes(nodes: int, feat: int, c1: int, c2: int, elem_bytes: int = 4) -> int:
    """Shared memory of one block of ``tower_fwd_kernel``: the forward plan
    of ``csrc/tower_common.cuh:plan``, which K8f runs too
    (:func:`~deeprank2_tpu_torch.ops.tower_plan.plan_bytes`; ``elem_bytes``
    4 in the f32 form, 2 in the bf16 form)."""
    return plan_bytes(nodes, feat, c1, c2, elem_bytes, forward=True)


def tower_bwd_smem_bytes(nodes: int, c1: int, c2: int, elem_bytes: int = 4) -> int:
    """Shared memory of one block of ``tower_bwd_kernel`` (the plan of
    ``csrc/diag_tower.cu:bwd_plan``; ``elem_bytes`` 4 in the f32 form, 2 in
    the bf16 form), channels padded to 4 (``c1p``, ``c2p``): the adjacency's
    bit rows ``[N, words]``, the sign of h2 ``[c2p, words]`` and ``h1 > 0``
    ``[c1p, words]`` (uint32) and the graph's ``g_pool`` ``[c2p]`` (f32);
    then, of ``elem_bytes`` each, w2 ``[c1p, ld(c2p)]``, the t2 slab
    ``[N, ld(c2p)]`` and the u1 slab ``[N, ld(c1p)]``, each row padded to an
    odd number of 16-byte units and each part to 16 bytes."""

    c1p, c2p, words = (c1 + 3) // 4 * 4, (c2 + 3) // 4 * 4, (nodes + 31) // 32
    ld1, ld2 = row_bytes(c1p, elem_bytes), row_bytes(c2p, elem_bytes)
    parts = (4 * nodes * words, 4 * c2p * words, 4 * c1p * words, 4 * c2p, c1p * ld2, nodes * ld2, nodes * ld1)
    return sum(round16(b) for b in parts)


def tower_supports(num_graphs: int, nodes: int, feat: int = 38, c1: int = 32, c2: int = 64) -> bool:
    """The fused flat tower's shape rule: at least one graph, and one
    graph's forward and backward each in the shared memory of one block
    (:func:`tower_fwd_smem_bytes` and the f32 form of
    :func:`tower_bwd_smem_bytes`, at most ``SMEM_LIMIT``). At GINetDense's
    widths (F=38, C1=32, C2=64) that is N <= 400 nodes a graph, the
    forward's limit (the batched forward's too; the backward's is N <= 457);
    beyond it a kernel raises."""
    fits = tower_fwd_smem_bytes(nodes, feat, c1, c2) <= SMEM_LIMIT and tower_bwd_smem_bytes(nodes, c1, c2) <= SMEM_LIMIT
    return num_graphs >= 1 and nodes >= 1 and fits


# ---------------------------------------------------------------------------
# K9f: tower_fwd_kernel (replaces deeprank2_tpu/ops/diag_spmm.py:_tower_fwd_kernel)


def tower_fwd_kernel_ref(adj_i8: torch.Tensor, x_t: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, compute_dtype=None):
    """Plain PyTorch version of :func:`tower_fwd_kernel` (the JAX
    ``_tower_ref``, with h2 kept as its sign); the bf16 form rounds ``x_t``,
    the weights, ``fcx1``, ``h1`` and ``fcx2`` before the products that take
    them, as the JAX kernel's ``split=False`` branch does."""
    act = activation_dtype(compute_dtype)
    h1 = diag_kernel_ref(adj_i8, round_to(w1, act).T @ round_to(x_t.float(), act), mask, "relu_mask", act)
    sign, pooled = diag_kernel_ref(adj_i8, round_to(w2, act).T @ round_to(h1, act), mask, "relu_mask_pool", act)
    return h1, sign, pooled


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32 (nearest,
    ties to even): CUDA's ``fmaf``. The product is exact in float64 and the
    sum's float64 rounding error is recovered exactly (TwoSum); only where
    the float64 sum sits on a float32 midpoint does that error pick the
    side, which is where rounding twice could differ from rounding once."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    toward = torch.nextafter(r, torch.where(s > r.double(), torch.full_like(r, float("inf")), torch.full_like(r, float("-inf"))))
    tie = (s == (r.double() + toward.double()) / 2) & (err != 0)
    past = (err > 0) == (toward > r)  # the exact sum lies beyond the midpoint, on toward's side
    return torch.where(tie & past, toward, r)


def tower_fwd_order_ref(adj_i8: torch.Tensor, x_t: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, compute_dtype=None):
    """:func:`tower_fwd_kernel`'s ``(h1, sign)`` in the kernel's summation
    order, a plain float32 loop: the weight products as fused multiply-adds
    (:func:`fma_f32`) in ascending k from +0, each aggregate the neighbours'
    rows added in ascending order from +0, the relu and the mask, and the
    bf16 form's roundings (x and the weights as they are staged, fcx, h1 and
    fcx2 before the products that take them; h1 returned unrounded). The
    kernel's h1 and sign equal these bit for bit."""
    act = activation_dtype(compute_dtype)
    g, n, _ = adj_i8.shape
    live = mask.reshape(1, g, n).float()
    on = adj_i8 != 0

    def product(w, v):  # [K, C] and [K, G*N] -> [C, G, N], ascending k
        acc = torch.zeros(w.shape[1], v.shape[1], dtype=torch.float32, device=v.device)
        for k in range(w.shape[0]):
            acc = fma_f32(w[k][:, None], v[k][None, :], acc)
        return acc.reshape(-1, g, n)

    def relu_aggregate(v):  # [C, G, N] -> relu(A v) * mask, ascending neighbours
        acc = torch.zeros_like(v)
        for j in range(n):
            acc = torch.where(on[None, :, :, j], acc + v[:, :, j : j + 1], acc)
        return torch.relu(acc) * live

    h1 = relu_aggregate(round_to(product(round_to(w1, act), round_to(x_t.float(), act)), act))
    h2 = relu_aggregate(round_to(product(round_to(w2, act), round_to(h1, act).reshape(h1.shape[0], g * n)), act))
    return h1.reshape(-1, g * n), (h2 > 0).to(torch.uint8).reshape(-1, g * n)


def tower_fwd_kernel(adj_i8: torch.Tensor, x_t: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, compute_dtype=None):
    """The fused tower's forward on the flat layout: ``(h1, sign, pooled)``
    with ``h1 = relu(A (w1ᵀ x_t)) ⊙ mask`` (f32 ``[C1, G*N]``), ``sign``
    (uint8 ``[C2, G*N]``) ``= h2 > 0`` for ``h2 = relu(A (w2ᵀ h1)) ⊙ mask``,
    and ``pooled [C2, G]`` = h2 summed over each graph's nodes. ``adj_i8
    [G, N, N]`` (int8 0/1), ``x_t [F, G*N]`` (f32), ``mask [G, N]`` (bool),
    ``w1 [F, C1]``, ``w2 [C1, C2]`` (f32). ``compute_dtype=torch.bfloat16``
    runs the bf16 form."""
    g, n, f = _dims(adj_i8, x_t, (torch.int8,))
    dev = x_t.device
    c1, c2 = w1.shape[-1], w2.shape[-1]
    act = activation_dtype(compute_dtype)
    _require(x_t, "x_t", torch.float32, (f, g * n), dev)
    _require(mask, "mask", torch.bool, (g, n), dev)
    _require(w1, "w1", torch.float32, (f, c1), dev)
    _require(w2, "w2", torch.float32, (c1, c2), dev)
    if not _route(dev):
        return tower_fwd_kernel_ref(adj_i8, x_t, mask, w1, w2, act)
    lib = _tower_lib()
    with torch.cuda.device(dev):
        h1 = torch.empty((c1, g * n), dtype=torch.float32, device=dev)
        sign = torch.empty((c2, g * n), dtype=torch.uint8, device=dev)
        pooled = torch.empty((c2, g), dtype=torch.float32, device=dev)
        code = lib.tower_fwd_kernel(
            adj_i8.data_ptr(), x_t.data_ptr(), ACT_DTYPES[act], mask.data_ptr(), w1.data_ptr(), w2.data_ptr(), h1.data_ptr(), sign.data_ptr(),
            pooled.data_ptr(), g, n, f, c1, c2, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "tower_fwd_kernel")
    _count("tower_fwd_kernel", adj_i8, act)
    return h1, sign, pooled


# ---------------------------------------------------------------------------
# K9b: tower_bwd_kernel (replaces deeprank2_tpu/ops/diag_spmm.py:_tower_bwd_kernel)


def tower_bwd_kernel_ref(adj_i8: torch.Tensor, g_pool: torch.Tensor, sign: torch.Tensor, h1: torch.Tensor, w2: torch.Tensor, compute_dtype=None):
    """Plain PyTorch version of :func:`tower_bwd_kernel`; the bf16 form
    rounds ``u2`` (through ``g_pool``), ``t2``, ``w2`` and ``u1``, and
    returns ``t2`` and ``t1`` as bf16."""
    act = activation_dtype(compute_dtype)
    t2 = round_to(pool_bwd_kernel_ref(adj_i8, sign, g_pool, act), act)
    t1 = diag_kernel_ref(adj_i8, (round_to(w2, act) @ t2) * (h1 > 0).to(t2.dtype), compute_dtype=act)
    return t2.to(act), t1.to(act)


def tower_bwd_error_scale(adj_i8: torch.Tensor, g_pool: torch.Tensor, sign: torch.Tensor, h1: torch.Tensor, w2: torch.Tensor, compute_dtype=None):
    """``(|A| |u2|, |A| ((|w2| s2) ⊙ [h1 > 0]))`` with ``s2`` the first: the
    sums of the absolute values of the products that make ``t2`` and ``t1``
    (``g_pool`` and ``w2`` rounded in the bf16 form), the scale of their f32
    rounding error in any summation order (t1 cancels: its terms can be far
    larger than it)."""
    act = activation_dtype(compute_dtype)
    s2 = pool_bwd_kernel_ref(adj_i8, sign, round_to(g_pool, act).abs())
    return s2, diag_kernel_ref(adj_i8, (round_to(w2, act).abs() @ s2) * (h1 > 0).to(s2.dtype))


def tower_bwd_kernel(adj_i8: torch.Tensor, g_pool: torch.Tensor, sign: torch.Tensor, h1: torch.Tensor, w2: torch.Tensor, compute_dtype=None):
    """The fused tower's backward aggregates ``(t2, t1)``: ``t2 = A (sign ⊙
    broadcast(g_pool))`` (``[C2, G*N]``, the cotangent ``g_pool [C2, G]``
    (f32) broadcast over each graph's nodes) and ``t1 = A ((w2 t2) ⊙ [h1 >
    0])`` (``[C1, G*N]``), f32, or bf16 in the bf16 form
    (``compute_dtype=torch.bfloat16``). The weight gradients are
    ``dw2 = h1 t2ᵀ`` and ``dw1 = x_t t1ᵀ``."""
    g, n, c2 = _dims(adj_i8, sign, (torch.int8,))
    dev = sign.device
    c1 = h1.shape[0]
    act = activation_dtype(compute_dtype)
    _require(sign, "sign", torch.uint8, (c2, g * n), dev)
    _require(g_pool, "g_pool", torch.float32, (c2, g), dev)
    _require(h1, "h1", torch.float32, (c1, g * n), dev)
    _require(w2, "w2", torch.float32, (c1, c2), dev)
    if not _route(dev):
        return tower_bwd_kernel_ref(adj_i8, g_pool, sign, h1, w2, act)
    lib = _tower_lib()
    with torch.cuda.device(dev):
        t2 = torch.empty((c2, g * n), dtype=act, device=dev)
        t1 = torch.empty((c1, g * n), dtype=act, device=dev)
        code = lib.tower_bwd_kernel(
            adj_i8.data_ptr(), g_pool.data_ptr(), sign.data_ptr(), h1.data_ptr(), w2.data_ptr(), ACT_DTYPES[act], t2.data_ptr(), t1.data_ptr(),
            g, n, c1, c2, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, code, "tower_bwd_kernel")
    _count("tower_bwd_kernel", adj_i8, act)
    return t2, t1


class _TowerPooled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w1, w2, adj_i8, node_mask, x_t, compute_dtype):
        h1, sign, pooled = tower_fwd_kernel(adj_i8, x_t, node_mask, w1, w2, compute_dtype)
        ctx.save_for_backward(adj_i8, x_t, h1, sign, w2)
        ctx.compute_dtype = compute_dtype
        return pooled

    @staticmethod
    def backward(ctx, g_pool):
        adj_i8, x_t, h1, sign, w2 = ctx.saved_tensors
        t2, t1 = tower_bwd_kernel(adj_i8, g_pool.contiguous(), sign, h1, w2, ctx.compute_dtype)
        # the weight gradients contract over the flat node axis outside the
        # kernels, in f32 (bf16 t1/t2 widened), as in the JAX package
        return x_t.float() @ t1.float().T, h1 @ t2.float().T, None, None, None, None


def tower_pooled(adj_i8: torch.Tensor, node_mask: torch.Tensor, x_t: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole GINet no-cluster tower (two conv layers, relu/mask, and
    per-graph SUM pooling) as one forward and one backward kernel. Returns
    the pooled sums ``[C2, G]``; differentiable w.r.t. ``w1 [F, C1]`` and
    ``w2 [C1, C2]`` only (``x_t [F, G*N]`` is batch data).
    ``compute_dtype=torch.bfloat16`` runs the kernels' bf16 form (the JAX
    ``tower_pooled(..., compute_dtype=bfloat16)`` on its TPU route)."""
    return _TowerPooled.apply(w1.contiguous(), w2.contiguous(), adj_i8, node_mask, x_t, compute_dtype)


def _per_graph(adj: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``adj [G, N, N]`` (f32) times each graph's node columns of ``v [C, G*N]``."""
    g, n, _ = adj.shape
    return torch.einsum("gij,cgj->cgi", adj, v.reshape(-1, g, n)).reshape(v.shape)


class _TowerPooledBf16Ref(torch.autograd.Function):
    """The bf16 form of the tower in plain ops, written apart from the
    kernels' plain versions: the JAX ``split=False`` forward and the custom
    VJP of its ``tower_pooled``, each value rounded to bf16 (``round_to``)
    where the Pallas bodies round it; the weight gradients in f32."""

    @staticmethod
    def forward(ctx, w1, w2, adj_i8, node_mask, x_t):
        g, n, _ = adj_i8.shape
        adj, m = adj_i8.to(torch.float32), node_mask.to(torch.float32).reshape(1, -1)
        r = lambda t: round_to(t, torch.bfloat16)  # noqa: E731
        h1 = torch.relu(_per_graph(adj, r(r(w1).T @ r(x_t)))) * m
        h2 = torch.relu(_per_graph(adj, r(r(w2).T @ r(h1)))) * m
        ctx.save_for_backward(adj, w2, x_t, h1, h2)
        return h2.reshape(-1, g, n).sum(dim=2)

    @staticmethod
    def backward(ctx, g_pool):
        adj, w2, x_t, h1, h2 = ctx.saved_tensors
        r = lambda t: round_to(t, torch.bfloat16)  # noqa: E731
        u2 = (h2 > 0).to(torch.float32) * r(g_pool).repeat_interleave(adj.shape[1], dim=1)
        t2 = r(_per_graph(adj, u2))
        t1 = r(_per_graph(adj, r((r(w2) @ t2) * (h1 > 0).to(torch.float32))))
        return x_t @ t1.T, h1 @ t2.T, None, None, None


def tower_pooled_ref(adj_i8: torch.Tensor, node_mask: torch.Tensor, x_t: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`tower_pooled`: in the f32 form the JAX
    ``_tower_ref``'s pooled sums, autograd through the plain ops; in the
    bf16 form JAX's ``split=False`` forward and custom VJP, rounded where the
    kernels round (its VJP rounds where autograd through rounded plain ops
    would not). Runs on any device."""
    if activation_dtype(compute_dtype) == torch.bfloat16:
        return _TowerPooledBf16Ref.apply(w1, w2, adj_i8, node_mask, x_t)
    h1 = diag_layer_t_ref(adj_i8, node_mask, w1.T @ x_t)
    return diag_layer_pool_t_ref(adj_i8, node_mask, w2.T @ h1)
