"""Fused residual MADE: the CUDA kernels, their gate and entry point, their
launch counts and their plain PyTorch versions (port of
``normflows_tpu/ops/made_pallas.py``).

``csrc/made_fused.cu`` holds the counterparts of the TPU kernels
``_fwd_kernel`` and ``_bwd_kernel`` (made_pallas.py:89, :117): the whole
context-free residual MADE (first masked linear, R residual blocks, final
masked linear) in one forward call (the chain in 16-row tiles whose hidden
activations stay in shared memory, then the final layer on a grid of output
tiles), and a backward that recomputes them.  Built with ``nvcc`` for
``sm_90a`` at first use and loaded with ``ctypes`` (``ops/cuda_build.py``).

It is opt-in, as in the JAX package: ``MADE.forward`` takes
:func:`made_apply_fused` when ``backend.made_fusion_enabled()`` and
:func:`fusable` hold.  Each direction is an operator (``backend.kernel_op``):
``normflows_tpu_torch::fused_resmade`` (:data:`OP`) and
``normflows_tpu_torch::fused_resmade_backward`` (:data:`BACKWARD_OP`), the
second registered as the first's autograd.  On a CUDA tensor each launches
its kernels, on a CPU tensor it calls its plain version,
:func:`fused_resmade_reference` or :func:`fused_resmade_backward_reference`.

With bfloat16 weights (``set_compute_dtype(model, "bfloat16")``) the
rounding points are JAX's: every product's activation operand is rounded to
bfloat16 and summed in float32 with float32 biases, activations and
residual; in the backward every input cotangent is rounded to bfloat16.  The
weight cotangents are summed in float32 over the whole batch and cast to
bfloat16 once; JAX also rounds the sum of each 512-row tile (``TILE_B_BWD``)
to bfloat16, which where the tiles' sums cancel costs up to an ulp of a
tile's sum (see ``csrc/made_fused.cu``).

The kernels run every product on the tensor cores, each float32 operand
split into three bfloat16 terms that add back to it exactly;
:func:`split_bf16`, :func:`split_matmul`, :func:`fused_resmade_split` and
:func:`fused_resmade_backward_split` model that arithmetic for the tests.
With float32 weights the forward is therefore not bit-equal to the unfused
pass (torch's float32 GEMMs); it lies within rounding of float64.
"""

from __future__ import annotations

import ctypes

import torch
from torch.fx.experimental.symbolic_shapes import statically_known_true

from . import backend, cuda_build

SOURCE = cuda_build.CSRC / "made_fused.cu"

# Kernel launches made by this module since the count was last set to 0: one
# per forward call, one per backward call (the forward's two and the
# backward's four CUDA launches, each made by one C call, count once).
LAUNCHES = 0
BACKWARD_LAUNCHES = 0
# The same calls counted on the card, by [backward][0], when set to an int64
# (2, 2) tensor there (see backend.count_launch); None: off.
DEVICE_LAUNCHES = None

# The gate's constants, as in the JAX package (made_pallas.py:45, :270)
TILE_B = 256  # the least batch that is fused
WEIGHT_BYTES = 8 * 2**20  # R * 2 * H * H * 4 must fit
# The port's own limit: a tile block keeps two (16, H) float32 tiles in
# shared memory beside a ring of up to 77 KB, within the 227 KB a block may
# have.
MAX_HIDDEN = 768
# The tile pass reads its hidden tiles in whole chunks of 16 along H (the
# gate asks a multiple of 128)
HIDDEN_MULTIPLE = 16
SPLIT = 512  # rows of one float32 weight-gradient partial of the backward
ACTIVATIONS = {"relu": 0, "tanh": 1, "leaky_relu": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"made_fused_forward": [_P] * 11 + [_I] * 7 + [_P],
               "made_fused_backward": [_P] * 14 + [_I] * 7 + [_P],
               "made_fused_forward_occupancy": [_I, _I, _P],
               "made_fused_backward_occupancy": [_I, _I, _P]}


def _library():
    return cuda_build.library(SOURCE, _SIGNATURES)


def fusable(made, x, context) -> bool:
    """True when ``made`` and ``x`` (the input after preprocessing) fit the
    fused kernels: every condition of the JAX package's gate
    (made_pallas.py:232-272), a batch known to be at least :data:`TILE_B`,
    and H <= :data:`MAX_HIDDEN`.  A MADE with a context layer is refused
    with or without a context at the call, as JAX's gate refuses it."""
    from ..nets.made import MaskedResidualBlock

    if context is not None or made.context_layer is not None:
        return False
    if x.dim() != 2 or x.dtype != torch.float32:
        return False
    # a symbolic batch (torch.export) is not known to reach a tile: the
    # unfused pass, as a symbolic export leaves the JAX package's Pallas path
    if not statically_known_true(x.shape[0] >= TILE_B):
        return False
    blocks = list(made.blocks)
    if not blocks:
        return False
    cd = made.initial_layer.compute_dtype
    if cd not in (None, torch.bfloat16):
        return False
    for blk in blocks:
        if not isinstance(blk, MaskedResidualBlock) or blk.context_layer is not None:
            return False
        if blk.activation != blocks[0].activation:
            return False
        if blk.linear_0.compute_dtype != cd or blk.linear_1.compute_dtype != cd:
            return False
        if blk.linear_0.bias is None or blk.linear_1.bias is None:
            return False
    if made.initial_layer.bias is None:
        return False
    fin = made.final_layer
    if fin.compute_dtype != cd or fin.bias is None:
        return False
    H = made.initial_layer.weight.shape[0]
    if H % 128 != 0 or H > MAX_HIDDEN:
        return False
    return len(blocks) * 2 * H * H * 4 <= WEIGHT_BYTES


def pack(made):
    """The operands of :func:`fused_resmade` after ``x``: the masks
    multiplied into the weights in float32, then cast to bfloat16 when that
    is the compute dtype; the R blocks' weights and biases stacked; biases
    float32.  Differentiable."""
    blocks = list(made.blocks)
    cd = made.initial_layer.compute_dtype

    def w(layer):
        m = layer.weight * layer.mask
        return m.to(cd) if cd is not None else m

    return (w(made.initial_layer), made.initial_layer.bias,
            torch.stack([w(b.linear_0) for b in blocks]),
            torch.stack([b.linear_0.bias for b in blocks]),
            torch.stack([w(b.linear_1) for b in blocks]),
            torch.stack([b.linear_1.bias for b in blocks]),
            w(made.final_layer), made.final_layer.bias)


def made_apply_fused(made, x):
    """Run a context-free residual MADE on ``x`` (B, F), the input after
    preprocessing, through :func:`fused_resmade` on :func:`pack`'s operands;
    the caller checked :func:`fusable`."""
    out = fused_resmade(x.contiguous(), *pack(made), made.blocks[0].activation)
    return out.to(x.dtype)


def forward_workspace(B, H, P, bf16) -> int:
    """bfloat16 elements of the forward's workspace (``csrc/made_fused.cu``,
    ``made_fused_forward``): the final layer's operand h_R as term planes,
    one with bfloat16 weights and three with float32, and with float32
    weights Wf's three, each plane rounded up to 8 elements."""
    plane = lambda n: -(-n // 8) * 8  # noqa: E731
    return plane(B * H) if bf16 else 3 * (plane(B * H) + plane(P * H))


def _dims(x, w0, w1s, wf):
    B, F = x.shape
    return B, F, w0.shape[0], w1s.shape[0], wf.shape[0]


def _check(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation):
    """Raise on anything the kernels do not take."""
    if activation not in ACTIVATIONS:
        raise NotImplementedError(f"fused MADE: activation {activation}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("fused MADE: x must be a 2-D float32 tensor")
    B, F, H, R, P = _dims(x, w0, w1s, wf)
    want = {"w0": (w0, (H, F)), "b0": (b0, (H,)), "w1s": (w1s, (R, H, H)),
            "b1s": (b1s, (R, H)), "w2s": (w2s, (R, H, H)), "b2s": (b2s, (R, H)),
            "wf": (wf, (P, H)), "bf": (bf, (P,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused MADE: {name} has shape {tuple(t.shape)}, "
                             f"need {shape} for x {tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError("fused MADE: the operands lie on different devices")
        want_dtype = w0.dtype if name.startswith("w") else torch.float32
        if t.dtype != want_dtype:
            raise TypeError(f"fused MADE: {name} must be {want_dtype}, got {t.dtype}")
    if w0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused MADE: weights must be float32 or bfloat16, got {w0.dtype}")
    if x.is_cuda and (B < 1 or H > MAX_HIDDEN or H % HIDDEN_MULTIPLE):
        raise ValueError(f"fused MADE: B = {B}, H = {H}: the kernels take B >= 1 and H "
                         f"a multiple of {HIDDEN_MULTIPLE}, H <= {MAX_HIDDEN}")


def _launch(name, pointers, x, dims, activation, bf16):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_library(), name)(*(t.data_ptr() for t in pointers), *dims,
                                       ACTIVATIONS[activation], int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _forward_cuda(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation):
    global LAUNCHES
    operands = tuple(t.contiguous() for t in (x, w0, b0, w1s, b1s, w2s, b2s, wf, bf))
    B, _, H, _, P = dims = _dims(x, w0, w1s, wf)
    bf16 = w0.dtype == torch.bfloat16
    out = torch.empty(B, P, dtype=torch.float32, device=x.device)
    work = torch.empty(forward_workspace(B, H, P, bf16), dtype=torch.bfloat16,
                       device=x.device)
    _launch("made_fused_forward", (*operands, out, work), x, dims, activation, bf16)
    LAUNCHES += 1
    backend.count_launch(DEVICE_LAUNCHES, False, False)
    return out


def _forward_cpu(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation):
    return fused_resmade_reference(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation)


def _backward_cuda(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g, activation, scratch):
    global BACKWARD_LAUNCHES
    operands = tuple(t.contiguous() for t in (x, w0, b0, w1s, b1s, w2s, b2s, wf, bf))
    B, F, H, R, P = dims = _dims(x, w0, w1s, wf)
    new = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=x.device)  # noqa: E731
    dx, grads = new(B, F), new(sum(_sizes(F, H, R, P)))
    if scratch is None:
        scratch = new((4 * R + 2) * B * H)
    splits = -(-B // SPLIT)
    part = new(splits * grads.numel()) if splits > 1 else grads
    _launch("made_fused_backward", (*operands, g.contiguous(), dx, grads, scratch, part),
            x, dims, activation, w0.dtype == torch.bfloat16)
    BACKWARD_LAUNCHES += 1
    backend.count_launch(DEVICE_LAUNCHES, True, False)
    return dx, grads


def _backward_cpu(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g, activation, scratch):
    dx, dw0, db0, dw1s, db1s, dw2s, db2s, dwf, dbf = fused_resmade_backward_reference(
        x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g, activation)
    return dx, torch.cat([t.float().reshape(-1)
                          for t in (dw0, dw1s, dw2s, dwf, db0, db1s, db2s, dbf)])


def _sizes(F, H, R, P):
    """Elements of the weight and bias gradients in the backward's flat
    float32 output: dw0, dw1s, dw2s, dwf, then db0, db1s, db2s, dbf."""
    return [H * F, R * H * H, R * H * H, P * H, H, R * H, R * H, P]


def _unflatten(grads, w0, b0, w1s, b1s, w2s, b2s, wf, bf):
    """The backward's flat float32 gradients as ``(dw0, db0, dw1s, db1s,
    dw2s, db2s, dwf, dbf)``: the weights' in their dtype (one cast), the
    biases' float32."""
    sizes = _sizes(w0.shape[1], w0.shape[0], w1s.shape[0], wf.shape[0])
    n_weights = sum(sizes[:4])
    weights = grads[:n_weights].to(w0.dtype)
    pieces = list(weights.split(sizes[:4])) + list(grads[n_weights:].split(sizes[4:]))
    dw0, dw1s, dw2s, dwf, db0, db1s, db2s, dbf = (
        p.view(t.shape) for p, t in zip(pieces, (w0, w1s, w2s, wf, b0, b1s, b2s, bf)))
    return dw0, db0, dw1s, db1s, dw2s, db2s, dwf, dbf


def _backward_fake(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g, activation, scratch):
    B, F, H, R, P = _dims(x, w0, w1s, wf)
    return x.new_empty((B, F)), x.new_empty((sum(_sizes(F, H, R, P)),))


_OPERANDS = ("Tensor x, Tensor w0, Tensor b0, Tensor w1s, Tensor b1s, Tensor w2s, "
             "Tensor b2s, Tensor wf, Tensor bf")

BACKWARD_OP = backend.kernel_op(
    "fused_resmade_backward",
    f"({_OPERANDS}, Tensor g, str activation, Tensor(a!)? scratch) -> (Tensor, Tensor)",
    cpu=_backward_cpu, cuda=_backward_cuda, fake=_backward_fake)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:9])
    ctx.activation = inputs[9]


def _backward(ctx, g):
    operands = ctx.saved_tensors
    dx, grads = BACKWARD_OP(*operands, g.contiguous(), ctx.activation, None)
    grads = (dx, *_unflatten(grads, *operands[1:]))
    return (*(gr if want else None for gr, want in zip(grads, ctx.needs_input_grad)), None)


OP = backend.kernel_op(
    "fused_resmade", f"({_OPERANDS}, str activation) -> Tensor",
    cpu=_forward_cpu, cuda=_forward_cuda,
    fake=lambda x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation:
        x.new_empty((x.shape[0], wf.shape[0])),
    backward=_backward, setup_context=_setup_context)


def fused_resmade(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation="relu"):
    """The residual MADE MLP with its masks in the weights: x (B, F) float32,
    weights in the (out, in) layout, float32 or bfloat16 (w0 (H, F),
    w1s / w2s (R, H, H), wf (P, H)), float32 biases (b0 (H,), b1s / b2s
    (R, H), bf (P,)) -> (B, P) float32, through the operator :data:`OP`.

        h = x W0^T + b0;  R x  h += act(act(h) W1^T + b1) W2^T + b2;
        out = h Wf^T + bf

    Differentiable.  A CPU tensor takes :func:`fused_resmade_reference`; a
    CUDA tensor launches the kernel or raises; the backward follows the same
    rule."""
    _check(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation)
    return OP(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation)


def fused_resmade_backward(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g, activation="relu",
                           scratch=None):
    """Backward of :func:`fused_resmade`: the output cotangent ``g`` (B, P)
    -> ``(dx, dw0, db0, dw1s, db1s, dw2s, db2s, dwf, dbf)``, each shaped and
    typed like its operand, through the operator :data:`BACKWARD_OP`.  A
    CPU tensor takes :func:`fused_resmade_backward_reference`; a CUDA tensor
    launches the backward kernels or raises.  On the card ``scratch``, a
    contiguous float32 tensor of (4R + 2) B H elements, takes the kernels'
    recompute in place of a fresh buffer: viewed as (4R + 2, B, H), slabs 0
    ... R are h before each block (R: before the final layer) and slabs
    R + 1 ... 2R each block's inner pre-activation z, as the kernels
    computed them."""
    operands = (x, w0, b0, w1s, b1s, w2s, b2s, wf, bf)
    _check(*operands, activation)
    if tuple(g.shape) != (x.shape[0], wf.shape[0]) or g.dtype != torch.float32 \
            or g.device != x.device:
        raise ValueError(f"fused MADE backward: g must be a float32 "
                         f"{(x.shape[0], wf.shape[0])} tensor on {x.device}")
    R, B, H = w1s.shape[0], x.shape[0], w0.shape[0]
    if scratch is not None and (
            scratch.shape != ((4 * R + 2) * B * H,) or scratch.dtype != torch.float32
            or scratch.device != x.device or not scratch.is_contiguous()):
        raise ValueError(f"fused MADE backward: scratch must be a contiguous float32 "
                         f"tensor of {(4 * R + 2) * B * H} elements on {x.device}")
    dx, grads = BACKWARD_OP(*operands, g, activation, scratch)
    return (dx, *_unflatten(grads, *operands[1:]))


# ---- plain versions -----------------------------------------------------------

def _act(name, x):
    if name == "relu":
        return torch.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "leaky_relu":
        return torch.where(x >= 0, x, 0.01 * x)  # jax.nn.leaky_relu
    raise NotImplementedError(f"activation {name}")


def _act_grad(name, x):
    """JAX's derivatives: relu' = (x > 0), leaky_relu' = 1 or 0.01 at
    x >= 0 or below, tanh' = (1 + t)(1 - t)."""
    if name == "relu":
        return (x > 0).to(x.dtype)
    if name == "tanh":
        t = torch.tanh(x)
        return (1 + t) * (1 - t)
    if name == "leaky_relu":
        return torch.where(x >= 0, 1.0, 0.01).to(x.dtype)
    raise NotImplementedError(f"activation {name}")


def _rounding(bf16, dtype):
    """bfloat16 rounding of an operand kept in ``dtype``, or the identity."""
    if not bf16:
        return lambda a: a
    return lambda a: a.to(torch.bfloat16).to(dtype)


def _chain(x, w0, b0, w1s, b1s, w2s, b2s, activation, mm=None):
    """The plain forward up to the final layer's input, in ``x``'s dtype:
    ``(hs, zs, h)``, hs[r] the residual stream before block r, zs[r] the
    block's inner pre-activation, h the final layer's input.  ``mm(a, w)``
    takes each product of a rounded operand and a weight in the (out, in)
    layout (default: ``a @ w.T`` in ``x``'s dtype)."""
    dt = x.dtype
    rnd = _rounding(w0.dtype == torch.bfloat16, dt)
    mm = mm or (lambda a, w: a @ w.to(dt).T)
    hs, zs = [], []
    h = mm(rnd(x), w0) + b0.to(dt)
    for r in range(w1s.shape[0]):
        hs.append(h)
        zs.append(mm(rnd(_act(activation, h)), w1s[r]) + b1s[r].to(dt))
        h = h + (mm(rnd(_act(activation, zs[r])), w2s[r]) + b2s[r].to(dt))
    return hs, zs, h


def fused_resmade_reference(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation="relu"):
    """Plain PyTorch version of the forward kernel, in ``x``'s dtype (float32
    or float64), with JAX's rounding points when the weights are bfloat16:
    each product's activation operand rounded to bfloat16, the weights
    widened, the product summed in ``x``'s dtype."""
    dt = x.dtype
    _, _, h = _chain(x, w0, b0, w1s, b1s, w2s, b2s, activation)
    return _rounding(w0.dtype == torch.bfloat16, dt)(h) @ wf.to(dt).T + bf.to(dt)


def preactivations_reference(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation="relu"):
    """The plain forward's pre-activations, stacked over the R blocks: (the
    residual stream before each block, each block's inner z), (R, B, H)
    each, in ``x``'s dtype; the backward kernels keep theirs in the slabs 0
    ... R - 1 and R + 1 ... 2R of their scratch."""
    hs, zs, _ = _chain(x, w0, b0, w1s, b1s, w2s, b2s, activation)
    return torch.stack(hs), torch.stack(zs)


def fused_resmade_backward_reference(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g,
                                     activation="relu", kinks=None):
    """Plain PyTorch version of the backward kernels, the pull-back written
    out, in ``x``'s dtype: the forward recomputed, then each product's input
    cotangent (rounded to bfloat16 with bfloat16 weights) and its weight
    cotangent, summed over the batch and cast to the weight's dtype at the
    end, as the kernels do.  Returns ``(dx, dw0, db0, dw1s, db1s, dw2s, db2s, dwf,
    dbf)``, each in its operand's dtype.

    ``kinks = (hs, zs)``, R pre-activations each, gives the activation
    derivatives their arguments in place of the recomputed ones.  Passed the
    kernels' own (``fused_resmade_backward``'s ``scratch``), it takes their
    side of relu's step wherever a pre-activation lies within rounding of 0,
    where another order of the same sums may land on the other side."""
    return _backward(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g, activation, kinks,
                     lambda a, b, bf16_valued: a @ b)


# The kernels' split products (csrc/made_fused.cu): a float32 operand is the
# sum of three bfloat16 terms, and the products of terms i and j with
# i + j < SPLIT_ORDER are taken (with float32 weights 6 of the 9 partial
# products; with bfloat16 weights, one term, all 3 of the cotangent's).
SPLIT_ORDER = 3


def split_bf16(c, terms=3):
    """The kernels' split of a float32 tensor into ``terms`` bfloat16-valued
    float32 tensors: c0 = bf16(c), c1 = bf16(c - c0), c2 = bf16(c - c0 - c1).
    Each subtraction is exact, and for 2^-110 <= |c| < 2^127 (and c = 0)
    the three terms sum back to c exactly."""
    out, r = [], c.float()
    for _ in range(terms):
        t = r.to(torch.bfloat16).float()
        out.append(t)
        r = r - t
    return out


def split_matmul(a, b, a_terms=3, b_terms=3):
    """``a @ b`` as the kernels compute it: ``a`` and ``b`` (float32 values)
    split into terms, the partial products of terms i, j with
    i + j < SPLIT_ORDER, each exact, summed in float64."""
    ta, tb = split_bf16(a, a_terms), split_bf16(b, b_terms)
    return sum(ta[i].double() @ tb[j].double() for i in range(a_terms)
               for j in range(b_terms) if i + j < SPLIT_ORDER)


def fused_resmade_split(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, activation="relu"):
    """:func:`fused_resmade_reference` with each product taken as the forward
    kernels take it (:func:`split_matmul`): with float32 weights both
    operands in three terms (6 partial products), with bfloat16 weights the
    rounded operand and the weight one term each.  Each product is rounded
    to float32; biases, activations and the residual stay float32.  A model
    of the kernels' arithmetic, for tests."""
    bf16 = w0.dtype == torch.bfloat16
    terms = 1 if bf16 else 3

    def mm(a, w):
        return split_matmul(a, w.float().T, terms, terms).float()

    _, _, h = _chain(x.float(), w0, b0, w1s, b1s, w2s, b2s, activation, mm)
    return mm(_rounding(bf16, torch.float32)(h), wf) + bf


def fused_resmade_backward_split(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g,
                                 activation="relu", kinks=None):
    """:func:`fused_resmade_backward_reference` with each product taken as
    the kernels take it (:func:`split_matmul`): with bfloat16 weights the
    float32 cotangent in three terms, one where it is bfloat16 already (the
    last block's dh = bf16(g Wf), and dz1 under relu); with float32 weights
    both operands in three.  Each product is rounded to ``x``'s dtype.  A
    model of the kernels' arithmetic, for tests."""
    bf16 = w0.dtype == torch.bfloat16

    def mm(a, b, bf16_valued):
        return split_matmul(a, b, 1 if bf16 and bf16_valued else 3, 1 if bf16 else 3).to(a.dtype)

    return _backward(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g, activation, kinks, mm)


def _backward(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, g, activation, kinks, mm):
    """The pull-back of the backward versions; ``mm(a, b, bf16_valued)``
    takes every product, ``bf16_valued`` saying whether ``a`` is
    bfloat16-valued with bfloat16 weights (``b`` always is then)."""
    dt = x.dtype
    bf16 = w0.dtype == torch.bfloat16
    rnd = _rounding(bf16, dt)
    W = lambda w: w.to(dt)  # noqa: E731
    R = w1s.shape[0]
    g = g.to(dt)
    relu = activation == "relu"

    def wgrad(dc, a, bf16_valued=False):
        return mm(dc.T, rnd(a), bf16_valued)

    hs, zs, h = _chain(x, w0, b0, w1s, b1s, w2s, b2s, activation)
    kh, kz = (hs, zs) if kinks is None else [[t.to(dt) for t in k] for k in kinks]
    dwf, dbf = wgrad(g, h), g.sum(0)
    dh = rnd(mm(g, W(wf), False))
    dw1s, db1s, dw2s, db2s = [None] * R, [None] * R, [None] * R, [None] * R
    for r in reversed(range(R)):
        last = r == R - 1  # dh is bf16(g Wf) itself
        dw2s[r], db2s[r] = wgrad(dh, _act(activation, zs[r]), last), dh.sum(0)
        dz1 = rnd(mm(dh, W(w2s[r]), last)) * _act_grad(activation, kz[r])
        dw1s[r], db1s[r] = wgrad(dz1, _act(activation, hs[r]), relu), dz1.sum(0)
        dh = dh + rnd(mm(dz1, W(w1s[r]), relu)) * _act_grad(activation, kh[r])
    dw0, db0 = wgrad(dh, x), dh.sum(0)
    dx = rnd(mm(dh, W(w0), False))
    return (dx.to(x.dtype), dw0.to(w0.dtype), db0.to(b0.dtype),
            torch.stack(dw1s).to(w1s.dtype), torch.stack(db1s).to(b1s.dtype),
            torch.stack(dw2s).to(w2s.dtype), torch.stack(db2s).to(b2s.dtype),
            dwf.to(wf.dtype), dbf.to(bf.dtype))
