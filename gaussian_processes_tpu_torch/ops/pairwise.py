"""Pairwise covariance, its derivatives, and matrix-free products: B1-B6.

Counterpart of ``gaussian_processes_tpu/ops/pairwise.py`` (the leaf SE,
periodic, Matérn 3/2 and 5/2 and RQ kernels, Sum/Product trees of them, and
ARD-SE over (n, D) inputs).  Each public function is a wrapper: for
tensors on the CPU it evaluates the plain PyTorch version beside it; for
tensors on a CUDA card it launches the hand-written kernel of
``csrc/pairwise.cuh``, ``csrc/ard_pairwise.cu``, ``csrc/matvec.cuh`` or
``csrc/ard_matvec.cuh``, or raises.

* ``pairwise_matrix`` (B1) replaces ``_tile_body``: K[i, j] = k(x1_i - x2_j)
  with an optional (s^2 + jitter) on the global diagonal, written once.  A
  Sum/Product tree goes to the kernel as a sum of products of its leaves
  (``_tree_flat``, ``_tree_program``; ``tile_program`` is the same sum of
  products in plain PyTorch),
  at most ``MAX_TREE_LEAVES`` leaves.  B1 and B4 evaluate one folded element
  (``folded_values``; ``pairwise_matrix_folded`` is B1's own arithmetic),
  and ``pivot_rows`` gives the pivoted Cholesky its rows on parameters read
  once.
* ``pairwise_jacobian`` (B2a) replaces ``_jac_tile_body``: (P, n, m).
* ``pairwise_matrix_chains`` and ``pairwise_jacobian_chains`` are B1 and
  B2a over a (C, P) table of C chains' parameters, one launch each: the
  counterpart of the JAX package's ``vmap`` of those Pallas calls over the
  samplers' chains.  A tree's Jacobian comes from its leaves' launches by
  the matrix-level rule of ``models/composite.py``.
  ``jacobian_contract_chains`` is B2a over the table contracted with
  alpha alpha^T - K^-1 in the same launch (a leaf's gradient terms, the
  Jacobian never stored).
* ``pairwise_hessian`` (B2b) replaces ``_hess_tile_body``: (P, P, n, m)
  filled symmetrically from the upper triangle, or one (n, m) plane when a
  ``pair`` is given, which evaluates that value's closed form alone
  (``hessian_plane_folded`` is its arithmetic in plain PyTorch).
* ``pairwise_matrix_ard`` (B6) replaces ``_ard_tile_body``: ARD-SE K with
  B4-ARD's arithmetic on coordinates scaled by ``ard_scale``
  (``pairwise_ard_prescaled_reference`` in plain PyTorch).
* ``kernel_matvec_fused`` (B4 for leaves and trees, B4-ARD) replaces
  ``_matvec_tile_body`` and ``_ard_matvec_tile_body``: (K(x, x) + (s^2 +
  jitter) I) V with K never stored; the noise term is added outside the
  kernel.  B4-ARD
  (``csrc/ard_matvec.cuh``) takes coordinates pre-scaled by
  ``ard_prescale``; ``ard_matvec_prescaled_reference`` is its arithmetic in
  plain PyTorch.
* ``kernel_jacvec_fused`` (B5, leaves only) replaces ``_jacvec_tile_body``:
  the (P, n, r) stack of dK/dtheta_p U with dK/dtheta never stored.  B4 and
  B5 fold every constant out of the element; ``matvec_folded_reference``
  and ``jacvec_folded_reference`` are that arithmetic in plain PyTorch.

B1, B2 and B6 are bound by the HBM write of their output (n * m elements per
plane), B4 and B5 by the arithmetic of about n^2 closed-form evaluations;
the sources note what the designs do about it.  The plain versions of B4 and
B5 (``*_fused_reference``, the oracles and the CPU path) form strips of K
(or dK/dtheta) with the plain pairwise functions and contract them with
``torch.matmul``, as the JAX package's strip scan does.  The
hyperparameters stay on the device as a small tensor the kernel reads
through a pointer.

Autograd: B1 (``pairwise_matrix``) and B6 (``pairwise_matrix_ard``) carry
an autograd rule on the card (``_PairwiseK``, ``_PairwiseArdK``), the
counterpart of the JAX package's autodiff of its plain ``jnp`` kernel: the
forward is the unchanged launch; the backward takes dL/dtheta from B2a's
planes at the same (x1, x2) (a tree's from its matrix-level
``jacobian``), tr(G) for the diagonal term, and the input gradients (and
ARD's theta) from autograd of the plain element on the recomputed block,
only when asked.  The other wrappers (B2, B4, B5, the chain tables, the
pivot rows) raise if an input requires grad: the paths that use them carry
analytic gradients.

Launch counters: each wrapper counts under its kernel's name for SE and
periodic, and under the name and the family (``pairwise_k_matern52``,
``kernel_matvec_tree``, ...) for the families and trees ported after them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from gaussian_processes_tpu_torch.models.base import pairwise_diff, tri_index
from gaussian_processes_tpu_torch.ops import _build

_INT32_MAX = 2**31 - 1


def _vectors(x1, x2):
    x1 = torch.as_tensor(x1)
    x2 = torch.as_tensor(x2, device=x1.device)
    if x1.ndim != 1 or x2.ndim != 1:
        raise ValueError(
            f"pairwise kernels take 1-D inputs, got {tuple(x1.shape)} and "
            f"{tuple(x2.shape)}"
        )
    if x1.dtype != x2.dtype:
        raise TypeError(f"x1 is {x1.dtype} but x2 is {x2.dtype}")
    return x1.contiguous(), x2.contiguous()


def _params_like(kernel, x):
    return kernel.params.to(device=x.device, dtype=x.dtype)


def _diag_term(noise, jitter, x):
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    if noise.ndim != 0:
        raise ValueError("pairwise_matrix takes a scalar noise; build_kxx "
                         "adds per-point noise")
    return torch.square(noise) + jitter


def _family(kernel) -> int:
    fam = type(kernel).cuda_family
    if fam is None:
        raise TypeError(f"{type(kernel).__name__} has no CUDA closed form")
    return fam


# -- Sum/Product trees: the counterpart of tile_program / _fn_from_structure --

#: the most leaves a tree may have on the card (gp::kMaxTreeLeaves)
MAX_TREE_LEAVES = 8
_TREE = 5  # gp::kTree
#: the launch counters' suffix of each family (SE and periodic count under
#: the kernel's bare name)
_COUNTER_SUFFIX = {0: "", 1: "", 2: "_matern32", 3: "_matern52", 4: "_rq", _TREE: "_tree"}


def is_tree(kernel) -> bool:
    """True for a Sum/Product kernel (``models/composite.py``)."""
    from gaussian_processes_tpu_torch.models.composite import _CompositeKernel

    return isinstance(kernel, _CompositeKernel)


def _tree_structure(kernel):
    """The tree's static structure: ("sum" | "prod", left, right) or
    ("leaf", class); TypeError for a leaf without a closed form (as the JAX
    package's ``_tile_structure`` raises for an ARD leaf)."""
    from gaussian_processes_tpu_torch.models.composite import ProductKernel, SumKernel

    if isinstance(kernel, SumKernel):
        return ("sum", _tree_structure(kernel.k1), _tree_structure(kernel.k2))
    if isinstance(kernel, ProductKernel):
        return ("prod", _tree_structure(kernel.k1), _tree_structure(kernel.k2))
    if _has_closed_form(kernel):
        return ("leaf", type(kernel))
    raise TypeError(
        f"{type(kernel).__name__} has no CUDA closed form (a tree's leaves need a "
        "static k_fn over 1-D differences); ARD kernels use pairwise_matrix_ard")


@functools.lru_cache(maxsize=None)
def _tree_flat(struct):
    """A tree structure as a sum of products of its leaves: ``(leaves,
    masks)``, ``leaves`` a tuple of (class, offset of its first parameter)
    in k1-before-k2 order and ``masks`` one int per product whose bit l
    selects leaf l.  A sum concatenates its children's products, a product
    multiplies them out (k1's outer): (a + b)(c + d) gives ac, ad, bc, bd.
    The kernels and ``folded_values`` evaluate this form; cached per
    structure."""
    leaves = []

    def walk(node):
        if node[0] == "leaf":
            offset = sum(len(cls.param_names) for cls, _ in leaves)
            leaves.append((node[1], offset))
            return [1 << (len(leaves) - 1)]
        left, right = walk(node[1]), walk(node[2])
        if node[0] == "sum":
            return left + right
        return [a | b for a in left for b in right]

    masks = walk(struct)
    return tuple(leaves), tuple(masks)


@functools.lru_cache(maxsize=None)
def _tree_program(struct):
    """The sum of products of a tree structure (``_tree_flat``) in the
    kernels' host encoding (csrc/closed_forms.cuh, ``parse_tree``):
    {n_leaves, family_0, offset_0, ..., n_terms, mask_0, ...}.  Cached per
    structure, as the JAX package caches the composed function, so the
    array outlives every launch that points at it."""
    leaves, masks = _tree_flat(struct)
    if len(leaves) > MAX_TREE_LEAVES:
        raise ValueError(f"a tree of {len(leaves)} leaves; the CUDA kernels take at most "
                         f"{MAX_TREE_LEAVES}")
    code = [len(leaves)] + [v for cls, offset in leaves for v in (cls.cuda_family, offset)]
    code += [len(masks), *masks]
    return (ctypes.c_int * len(code))(*code)


def tile_program(kernel):
    """(fn, params) of a leaf or a Sum/Product tree, the counterpart of the
    JAX package's ``tile_program``: ``fn(x1, x2, params)`` is the plain
    elementwise K (n, m) at the (P,) parameters ``params``.  For a tree it is
    the sum of products of ``_tree_flat``, the form kernels B1 and B4
    evaluate; TypeError for a kernel without a closed form (ARD)."""
    leaves, masks = _tree_flat(_tree_structure(kernel))

    def fn(x1, x2, params):
        d = x1[:, None] - x2[None, :]
        values = [cls.k_fn(d, *params[off:off + len(cls.param_names)].unbind(0))
                  for cls, off in leaves]
        out = None
        for mask in masks:
            term = None
            for bit, v in enumerate(values):
                if mask >> bit & 1:
                    term = v if term is None else term * v
            out = term if out is None else out + term
        return out

    return fn, kernel.params


def _launch_family(kernel):
    """(family, program address or None, launch-counter suffix) of a leaf or
    a tree for the CUDA entry points."""
    if is_tree(kernel):
        return _TREE, ctypes.addressof(_tree_program(_tree_structure(kernel))), "_tree"
    fam = _family(kernel)
    return fam, None, _COUNTER_SUFFIX[fam]


def _leaf_class(kernel):
    """The class whose static jac_fn / hess_fn B2 evaluates; TypeError for a
    tree, whose derivatives are built at matrix level from its children
    (``models/composite.py``), as in the JAX package."""
    if is_tree(kernel):
        raise TypeError(f"{type(kernel).__name__}: a Sum/Product tree has no pairwise "
                        "derivative form; use its jacobian / hessian / hessian_pair")
    return type(kernel)


def _k_fn(kernel):
    """The elementwise k of a leaf (its class's static k_fn) or a tree (the
    composite's instance k_fn); a tree's leaves are checked first."""
    if is_tree(kernel):
        _tree_structure(kernel)
        return kernel.k_fn
    return type(kernel).k_fn


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise on anything the CUDA kernels do not take."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: tensors must all be float32 or all "
                            f"float64, got {[u.dtype for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: the CUDA kernel has no autograd rule; "
                               "inputs must not require grad")


def _launch_k(kernel, x1, x2, params, with_diag: bool) -> torch.Tensor:
    _check_cuda("pairwise_matrix", x1, x2, params)
    n, m = x1.shape[0], x2.shape[0]
    if params.shape != (kernel.n_params + int(with_diag),):
        raise ValueError(f"pairwise_matrix: params has shape {tuple(params.shape)}")
    if max(n, m) > _INT32_MAX:
        raise ValueError("pairwise_matrix: n and m must fit in int32")
    out = torch.empty((n, m), dtype=x1.dtype, device=x1.device)
    if n == 0 or m == 0:
        return out
    family, tree, suffix = _launch_family(kernel)
    status = _build.entry("gp_pairwise_k", x1.dtype)(
        x1.device.index, x1.data_ptr(), x2.data_ptr(), params.data_ptr(),
        out.data_ptr(), n, m, family, tree, int(with_diag),
        _build.stream_of(x1),
    )
    _build.check(status, "gp_pairwise_k")
    _build.launch_counts["pairwise_k" + suffix] += 1
    return out


def _launch_deriv(kernel, x1, x2, params, order: int, value: int, shape):
    """B2a (``order`` 1) or B2b (2): every plane for ``value`` -1, else the
    plane of that upper-triangle value."""
    name = "pairwise_jacobian" if order == 1 else "pairwise_hessian"
    _check_cuda(name, x1, x2, params)
    n, m = x1.shape[0], x2.shape[0]
    if params.shape != (kernel.n_params,):
        raise ValueError(f"{name}: params has shape {tuple(params.shape)}")
    if max(n, m) > _INT32_MAX:
        raise ValueError(f"{name}: n and m must fit in int32")
    out = torch.empty(shape, dtype=x1.dtype, device=x1.device)
    if n == 0 or m == 0:
        return out
    family = _family(kernel)
    status = _build.entry("gp_pairwise_deriv", x1.dtype)(
        x1.device.index, x1.data_ptr(), x2.data_ptr(), params.data_ptr(),
        out.data_ptr(), n, m, family, order, value,
        _build.stream_of(x1),
    )
    _build.check(status, "gp_pairwise_deriv")
    name = "pairwise_jac" if order == 1 else "pairwise_hess"
    _build.launch_counts[name + _COUNTER_SUFFIX[family]] += 1
    return out


def _wants_grad(*tensors) -> bool:
    """True when autograd records and an input of a launch requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _theta_grad(kernel, x1, x2, G) -> torch.Tensor:
    """(P,) sum_ij G_ij dK_ij/dtheta_p: B2a's planes on a card for a leaf, a
    tree's matrix-level ``jacobian`` (its leaves' B1 and B2a launches)."""
    J = kernel.jacobian(x1, x2)
    return J.reshape(J.shape[0], -1) @ G.reshape(-1)


class _PairwiseK(torch.autograd.Function):
    """Kernel B1 with its backward.  Inputs x1, x2 (1-D) and params (P,) or
    (P + 1,) with the diagonal term s^2 + jitter last."""

    @staticmethod
    def forward(ctx, x1, x2, params, kernel, with_diag):
        x1, x2, params = x1.detach(), x2.detach(), params.detach()
        ctx.save_for_backward(x1, x2, params)
        ctx.kernel, ctx.with_diag = kernel, with_diag
        return _launch_k(kernel, x1, x2, params, with_diag)

    @staticmethod
    def backward(ctx, G):
        x1, x2, params = ctx.saved_tensors
        kernel = ctx.kernel
        theta = params[:kernel.n_params]
        g_x1 = g_x2 = g_params = None
        if ctx.needs_input_grad[2]:
            g_params = _theta_grad(kernel.with_params(theta), x1, x2, G)
            if ctx.with_diag:
                g_params = torch.cat([g_params, torch.diagonal(G).sum()[None]])
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            # d K_ij / d x1_i = k'(d_ij) = - d K_ij / d x2_j: autograd of the
            # plain element on the recomputed differences
            with torch.enable_grad():
                d = pairwise_diff(x1, x2).requires_grad_()
                (gd,) = torch.autograd.grad(_k_fn(kernel)(d, *theta.unbind(0)), d, G)
            g_x1 = gd.sum(1) if ctx.needs_input_grad[0] else None
            g_x2 = -gd.sum(0) if ctx.needs_input_grad[1] else None
        return g_x1, g_x2, g_params, None, None


def _unsupported(x) -> RuntimeError:
    return RuntimeError(f"no pairwise kernel for device {x.device}")


# ---------------------------------------------------------------------------
# B1: K
# ---------------------------------------------------------------------------


def pairwise_matrix(kernel, x1, x2, *, noise=None, jitter: float = 0.0) -> torch.Tensor:
    """K[i, j] = k(x1[i], x2[j]) (+ (noise^2 + jitter) on the diagonal when
    a scalar noise is given).  The CUDA path is kernel B1, for a
    Sum/Product tree its tree body."""
    x1, x2 = _vectors(x1, x2)
    if x1.device.type == "cpu":
        return pairwise_matrix_reference(kernel, x1, x2, noise=noise, jitter=jitter)
    if x1.device.type != "cuda":
        raise _unsupported(x1)
    params = _params_like(kernel, x1)
    with_diag = noise is not None
    if with_diag:
        params = torch.cat([params, _diag_term(noise, jitter, x1)[None]])
    if _wants_grad(x1, x2, params):
        return _PairwiseK.apply(x1, x2, params, kernel, with_diag)
    return _launch_k(kernel, x1, x2, params, with_diag)


def pairwise_matrix_reference(kernel, x1, x2, *, noise=None, jitter=0.0) -> torch.Tensor:
    """Plain PyTorch twin of ``pairwise_matrix`` (B1's oracle and CPU path)."""
    x1, x2 = _vectors(x1, x2)
    params = _params_like(kernel, x1)
    K = _k_fn(kernel)(pairwise_diff(x1, x2), *params.unbind(0))
    if noise is not None:
        K.diagonal().add_(_diag_term(noise, jitter, x1))
    return K


def pivot_rows(kernel, x):
    """``row(xp)`` -> K(xp, x)[0], the (n,) kernel row of one point ``xp``
    (a (1,) or (1, D) tensor on x's device), for a pivoted Cholesky that
    builds one row per step.  On a card a 1-D leaf or tree reads its
    parameters once, here, and each row is one B1 launch on that pointer
    into a buffer the rows share: a row is valid until the next call, and
    equals ``pairwise_matrix(kernel, xp, x)`` bit for bit.  Elsewhere (the
    CPU, ARD) each row is ``kernel(xp, x)[0]``."""
    x = torch.as_tensor(x)
    if x.device.type != "cuda" or x.ndim != 1:
        return lambda xp: kernel(xp, x)[0]
    x, _ = _vectors(x, x)
    params = _params_like(kernel, x).contiguous()
    _check_cuda("pivot_rows", x, params)
    n = x.shape[0]
    if n > _INT32_MAX:
        raise ValueError("pivot_rows: n must fit in int32")
    family, tree, suffix = _launch_family(kernel)
    out = torch.empty((1, n), dtype=x.dtype, device=x.device)
    launch = _build.entry("gp_pairwise_k", x.dtype)
    args = (ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(params.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), 1, n, family, tree, 0, _build.stream_of(x))
    index = x.device.index
    counter = "pairwise_k" + suffix

    def row(xp, keep=(x, params, out)):  # keep: the tensors behind the pointers
        if xp.shape != (1,) or xp.device != x.device or xp.dtype != x.dtype:
            raise ValueError(f"pivot_rows: the point must be (1,) {x.dtype} on {x.device}, got "
                             f"{tuple(xp.shape)} {xp.dtype} on {xp.device}")
        _build.check(launch(index, xp.data_ptr(), *args), "gp_pairwise_k")
        _build.launch_counts[counter] += 1
        return out[0]

    return row


# ---------------------------------------------------------------------------
# B2: dK/dtheta and d2K/dtheta2
# ---------------------------------------------------------------------------


def pairwise_jacobian(kernel, x1, x2) -> torch.Tensor:
    """dK/dtheta, (P, n, m).  The CUDA path is kernel B2a."""
    x1, x2 = _vectors(x1, x2)
    _leaf_class(kernel)
    if x1.device.type == "cpu":
        return pairwise_jacobian_reference(kernel, x1, x2)
    if x1.device.type != "cuda":
        raise _unsupported(x1)
    return _launch_deriv(kernel, x1, x2, _params_like(kernel, x1), 1, -1,
                         (kernel.n_params, x1.shape[0], x2.shape[0]))


def pairwise_jacobian_reference(kernel, x1, x2) -> torch.Tensor:
    """Plain PyTorch twin of ``pairwise_jacobian``."""
    x1, x2 = _vectors(x1, x2)
    params = _params_like(kernel, x1)
    return torch.stack(_leaf_class(kernel).jac_fn(pairwise_diff(x1, x2), *params.unbind(0)))


def pairwise_hessian(kernel, x1, x2, *, pair=None) -> torch.Tensor:
    """d2K/dtheta2: (P, P, n, m), or the (n, m) plane ``pair=(p, q)``.
    The CUDA path is kernel B2b."""
    x1, x2 = _vectors(x1, x2)
    _leaf_class(kernel)
    if x1.device.type == "cpu":
        return pairwise_hessian_reference(kernel, x1, x2, pair=pair)
    if x1.device.type != "cuda":
        raise _unsupported(x1)
    P = kernel.n_params
    n, m = x1.shape[0], x2.shape[0]
    if pair is None:
        return _launch_deriv(kernel, x1, x2, _params_like(kernel, x1), 2, -1, (P, P, n, m))
    return _launch_deriv(kernel, x1, x2, _params_like(kernel, x1), 2,
                         tri_index(pair[0], pair[1], P), (n, m))


def pairwise_hessian_reference(kernel, x1, x2, *, pair=None) -> torch.Tensor:
    """Plain PyTorch twin of ``pairwise_hessian``."""
    x1, x2 = _vectors(x1, x2)
    params = _params_like(kernel, x1)
    tri = _leaf_class(kernel).hess_fn(pairwise_diff(x1, x2), *params.unbind(0))
    P = kernel.n_params
    if pair is not None:
        return tri[tri_index(pair[0], pair[1], P)]
    return torch.stack([tri[tri_index(p, q, P)] for p in range(P) for q in range(P)]
                       ).reshape(P, P, x1.shape[0], x2.shape[0])


# ---------------------------------------------------------------------------
# B1 and B2a over a chain dimension: one launch for C parameter vectors
# ---------------------------------------------------------------------------


def _chain_params(kernel_template, x, params):
    """``params`` as a (C, P) tensor in x's dtype and device whose rows may
    be a view with any row stride (the kernels take the stride)."""
    params = torch.as_tensor(params, device=x.device)
    if params.dtype != x.dtype:
        params = params.to(x.dtype)
    P = kernel_template.n_params
    if params.ndim != 2 or params.shape[1] != P:
        raise ValueError(f"chain parameters must be (C, {P}), got {tuple(params.shape)}")
    if params.stride(1) != 1:
        params = params.contiguous()
    return params


def _check_chains(name, x, params):
    """What ``_check_cuda`` asks, for a table whose rows may be strided."""
    _check_cuda(name, x)
    if params.device != x.device:
        raise ValueError(f"{name}: the table is on {params.device}, x on {x.device}")
    if params.requires_grad:
        raise RuntimeError(f"{name}: the CUDA kernel has no autograd rule; "
                           "inputs must not require grad")
    if params.shape[0] > 65535 or x.shape[0] > _INT32_MAX:
        raise ValueError(f"{name}: at most 65535 chains and n in int32, got "
                         f"{params.shape[0]} and {x.shape[0]}")


def pairwise_matrix_chains(kernel_template, x, params, diag) -> torch.Tensor:
    """K_c = k(x_i - x_j; params[c]) + diag[c] I for every chain c: (C, n, n).

    ``params`` is (C, P) in ``kernel_template``'s parameter order and
    ``diag`` (C,) the diagonal term s_c^2 + jitter of each chain.  The CUDA
    path is kernel B1 over the (C, P + 1) table [params, diag], one launch."""
    x, _ = _vectors(x, x)
    params = _chain_params(kernel_template, x, params)
    diag = torch.as_tensor(diag, dtype=x.dtype, device=x.device)
    if diag.shape != params.shape[:1]:
        raise ValueError(f"diag must be ({params.shape[0]},), got {tuple(diag.shape)}")
    if x.device.type == "cpu":
        return pairwise_matrix_chains_reference(kernel_template, x, params, diag)
    if x.device.type != "cuda":
        raise _unsupported(x)
    table = torch.cat([params, diag[:, None]], dim=1)
    _check_chains("pairwise_matrix_chains", x, table)
    C, stride = table.shape
    n = x.shape[0]
    out = torch.empty((C, n, n), dtype=x.dtype, device=x.device)
    if n == 0 or C == 0:
        return out
    family, tree, suffix = _launch_family(kernel_template)
    status = _build.entry("gp_pairwise_k_chains", x.dtype)(
        x.device.index, x.data_ptr(), x.data_ptr(), table.data_ptr(), out.data_ptr(),
        n, n, C, stride, family, tree, 1, _build.stream_of(x),
    )
    _build.check(status, "gp_pairwise_k_chains")
    _build.launch_counts["pairwise_k_chains" + suffix] += 1
    return out


def pairwise_matrix_chains_reference(kernel_template, x, params, diag) -> torch.Tensor:
    """Plain PyTorch twin of ``pairwise_matrix_chains``: the closed form
    broadcast over the chain dimension."""
    x, _ = _vectors(x, x)
    params = _chain_params(kernel_template, x, params)
    d = pairwise_diff(x, x)[None]
    K = _k_fn(kernel_template)(d, *(p[:, None, None] for p in params.unbind(1)))
    K.diagonal(dim1=-2, dim2=-1).add_(torch.as_tensor(diag, dtype=x.dtype,
                                                      device=x.device)[:, None])
    return K


def pairwise_jacobian_chains(kernel_template, x, params) -> torch.Tensor:
    """dK_c/dtheta for every chain c: (C, P, n, n).  The CUDA path is kernel
    B2a over the (C, P) table (rows may be a strided view), one launch; for
    a tree, ``tree_jacobian_chains`` over its leaves' launches."""
    x, _ = _vectors(x, x)
    params = _chain_params(kernel_template, x, params)
    if is_tree(kernel_template):
        return tree_jacobian_chains(kernel_template, x, params)
    if x.device.type == "cpu":
        return pairwise_jacobian_chains_reference(kernel_template, x, params)
    if x.device.type != "cuda":
        raise _unsupported(x)
    _check_chains("pairwise_jacobian_chains", x, params)
    C, P = params.shape
    n = x.shape[0]
    out = torch.empty((C, P, n, n), dtype=x.dtype, device=x.device)
    if n == 0 or C == 0:
        return out
    family = _family(kernel_template)
    status = _build.entry("gp_pairwise_jac_chains", x.dtype)(
        x.device.index, x.data_ptr(), x.data_ptr(), params.data_ptr(), out.data_ptr(),
        n, n, C, params.stride(0), family, _build.stream_of(x),
    )
    _build.check(status, "gp_pairwise_jac_chains")
    _build.launch_counts["pairwise_jac_chains" + _COUNTER_SUFFIX[family]] += 1
    return out


def tree_jacobian_chains(kernel_template, x, params, *, reference: bool = False):
    """(C, P, n, n) dK_c/dtheta of a Sum/Product tree for every chain, by
    ``models/composite.py``'s matrix-level rule from the children over
    their column slices of the table: [J1, J2] for a sum, [J1 K2, K1 J2] for
    a product.  The children's K and dK/dtheta come from the chain wrappers
    (B1 and B2a on a card), or from their plain versions with ``reference``."""
    from gaussian_processes_tpu_torch.models.composite import SumKernel

    k1, k2 = kernel_template.k1, kernel_template.k2
    p1 = k1.n_params
    t1, t2 = params[:, :p1], params[:, p1:]
    jac = pairwise_jacobian_chains_reference if reference else pairwise_jacobian_chains
    J1, J2 = jac(k1, x, t1), jac(k2, x, t2)
    if isinstance(kernel_template, SumKernel):
        return torch.cat([J1, J2], dim=1)
    build = pairwise_matrix_chains_reference if reference else pairwise_matrix_chains
    zero = params.new_zeros(params.shape[0])
    K1, K2 = build(k1, x, t1, zero), build(k2, x, t2, zero)
    return torch.cat([J1 * K2[:, None], K1[:, None] * J2], dim=1)


def pairwise_jacobian_chains_reference(kernel_template, x, params) -> torch.Tensor:
    """Plain PyTorch twin of ``pairwise_jacobian_chains``."""
    x, _ = _vectors(x, x)
    params = _chain_params(kernel_template, x, params)
    if is_tree(kernel_template):
        return tree_jacobian_chains(kernel_template, x, params, reference=True)
    d = pairwise_diff(x, x)[None]
    return torch.stack(type(kernel_template).jac_fn(
        d, *(p[:, None, None] for p in params.unbind(1))), dim=1)


def jacobian_contract_chains(kernel_template, x, params, alpha, inv_K) -> torch.Tensor:
    """(C, P): 1/2 sum_ij dK_c/dtheta_p[i, j] (alpha_ci alpha_cj - inv_K_cij)
    for every chain c, the kernel-parameter terms of the chains' gradient.

    ``params`` is the (C, P) table (rows may be a strided view), ``alpha``
    (C, n) and ``inv_K`` (C, n, n), symmetric.  The CUDA path is kernel B2a
    contracted, one launch and a second pass over its block partials, with
    dK/dtheta never stored and K^-1's upper triangle read; a leaf family
    only (TypeError for a tree)."""
    x, _ = _vectors(x, x)
    params = _chain_params(kernel_template, x, params)
    _leaf_class(kernel_template)
    C, P = params.shape
    n = x.shape[0]
    if alpha.shape != (C, n) or inv_K.shape != (C, n, n):
        raise ValueError(f"alpha and inv_K must be ({C}, {n}) and ({C}, {n}, {n}), got "
                         f"{tuple(alpha.shape)} and {tuple(inv_K.shape)}")
    if x.device.type == "cpu":
        return jacobian_contract_chains_reference(kernel_template, x, params, alpha, inv_K)
    if x.device.type != "cuda":
        raise _unsupported(x)
    alpha, inv_K = alpha.contiguous(), inv_K.contiguous()
    _check_chains("jacobian_contract_chains", x, params)
    _check_cuda("jacobian_contract_chains", x, alpha, inv_K)
    out = torch.empty((C, P), dtype=x.dtype, device=x.device)
    if n == 0 or C == 0:
        return out.zero_()
    partial = torch.empty((C, P, _contract_blocks(n, x.dtype)), dtype=x.dtype, device=x.device)
    family = _family(kernel_template)
    status = _build.entry("gp_pairwise_jac_contract_chains", x.dtype)(
        x.device.index, x.data_ptr(), params.data_ptr(), alpha.data_ptr(), inv_K.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, C, params.stride(0), family,
        _build.stream_of(x),
    )
    _build.check(status, "gp_pairwise_jac_contract_chains")
    _build.launch_counts["pairwise_jac_contract_chains" + _COUNTER_SUFFIX[family]] += 1
    return out


@functools.lru_cache(maxsize=None)
def _contract_blocks(n: int, dtype) -> int:
    """The blocks of B2a's grid over an (n, n) plane, the partials a chain
    and plane of B2a contracted; cached per (n, dtype), so a value+grad
    makes no host call to learn it."""
    return _build.entry("gp_pairwise_jac_contract_blocks", dtype)(n)


def jacobian_contract_chains_reference(kernel_template, x, params, alpha, inv_K) -> torch.Tensor:
    """Plain PyTorch twin of ``jacobian_contract_chains``: the reference
    dK/dtheta contracted in its own layout."""
    x, _ = _vectors(x, x)
    params = _chain_params(kernel_template, x, params)
    _leaf_class(kernel_template)
    J = pairwise_jacobian_chains_reference(kernel_template, x, params)
    W = alpha[:, :, None] * alpha[:, None, :] - inv_K
    return 0.5 * torch.einsum("cpij,cij->cp", J, W)


def hessian_plane_folded(kernel, x1, x2, pair) -> torch.Tensor:
    """The plane ``pair=(p, q)`` of d2K/dtheta2 with B2b's one-plane
    arithmetic (``HessValue`` in csrc/closed_forms.cuh): the factors that do
    not depend on the element folded into constants, then that value's
    closed form alone.  SE: E = exp(a d^2), a = -1 / (2 w^2); periodic:
    u = d / 2p, s = sin u, E = exp(a s^2), a = -2 / w^2.  Matérn and RQ
    evaluate ``hess_fn`` and keep that value (``HessFromFull``)."""
    x1, x2 = _vectors(x1, x2)
    P = kernel.n_params
    value = tri_index(pair[0], pair[1], P)
    params = _params_like(kernel, x1)
    d = pairwise_diff(x1, x2)
    fam = _family(kernel)
    if fam == 0:
        h, w = params.unbind(0)
        iw2 = 1.0 / (w * w)
        d2 = d * d
        E = torch.exp((-0.5 * iw2) * d2)
        if value == 0:  # (h, h): 2 E
            return 2.0 * E
        if value == 1:  # (h, w): 2h / w^3 d^2 E
            return (2.0 * h * iw2 / w) * (d2 * E)
        # (w, w): d^2 E (h^2 / w^6 d^2 - 3 h^2 / w^4)
        return (d2 * E) * ((h * h) * (iw2 * iw2 * iw2) * d2 + -3.0 * (h * h) * (iw2 * iw2))
    if fam != 1:
        return type(kernel).hess_fn(d, *params.unbind(0))[value]
    h, w, p = params.unbind(0)
    iw2, iw, ip = 1.0 / (w * w), 1.0 / w, 1.0 / p
    h2, ip2 = h * h, ip * ip
    u = d * (0.5 * ip)
    s = torch.sin(u)
    s2 = s * s
    E = torch.exp((-2.0 * iw2) * s2)
    if value == 0:  # (h, h)
        return 2.0 * E
    if value == 1:  # (h, w)
        return (8.0 * h * iw2 * iw) * (s2 * E)
    s2u = torch.sin(2.0 * u)
    if value == 2:  # (h, p)
        return (2.0 * h * iw2 * ip2) * (d * s2u * E)
    if value == 3:  # (w, w)
        return (s2 * E) * (16.0 * h2 * (iw2 * iw2 * iw2) * s2 + -12.0 * h2 * (iw2 * iw2))
    if value == 4:  # (w, p)
        c1, c2 = 4.0 * h2 * (iw2 * iw2 * iw) * ip2, -2.0 * h2 * (iw2 * iw) * ip2
        return (d * s2u * E) * (c1 * s2 + c2)
    c2u = torch.cos(2.0 * u)  # (p, p)
    c1, c2 = h2 * (iw2 * iw2) * (ip2 * ip2), -h2 * iw2 * (ip2 * ip)
    return (d * E) * ((c1 * d) * (s2u * s2u) + c2 * ((d * c2u) * ip + 2.0 * s2u))


# ---------------------------------------------------------------------------
# B6: ARD K over (n, D) inputs
# ---------------------------------------------------------------------------

_MAX_ARD_DIM = 16  # the largest D the ARD kernels take (csrc/ard_pairwise.cu, ard_matvec.cuh)


def _is_ard(kernel) -> bool:
    from gaussian_processes_tpu_torch.models.ard import ARDGaussianKernel

    return isinstance(kernel, ARDGaussianKernel)


def _points(kernel, x1, x2):
    """(n, D) and (m, D) inputs of one dtype (``atleast_2d``, as in JAX)."""
    x1 = torch.atleast_2d(torch.as_tensor(x1))
    x2 = torch.atleast_2d(torch.as_tensor(x2, device=x1.device))
    D = kernel.w.shape[0]
    if x1.ndim != 2 or x1.shape[1] != D or x2.ndim != 2 or x2.shape[1] != D:
        raise ValueError(f"ARD inputs must be (n, {D}), got {tuple(x1.shape)} "
                         f"and {tuple(x2.shape)}")
    if x1.dtype != x2.dtype:
        raise TypeError(f"x1 is {x1.dtype} but x2 is {x2.dtype}")
    return x1.contiguous(), x2.contiguous()


def pairwise_matrix_ard(kernel, x1, x2, *, noise=None, jitter: float = 0.0) -> torch.Tensor:
    """ARD-SE K[i, j] = k(x1[i], x2[j]) over (n, D) and (m, D) inputs (+
    (noise^2 + jitter) on the diagonal when a scalar noise is given).  The
    CUDA path is kernel B6, which evaluates B4-ARD's arithmetic
    (``pairwise_ard_prescaled_reference``)."""
    if not _is_ard(kernel):
        raise TypeError("pairwise_matrix_ard expects an ARDGaussianKernel")
    x1, x2 = _points(kernel, x1, x2)
    if x1.device.type == "cpu":
        return pairwise_matrix_ard_reference(kernel, x1, x2, noise=noise, jitter=jitter)
    if x1.device.type != "cuda":
        raise _unsupported(x1)
    # h, w and the diagonal term by pointer: the kernel divides c / w_d as
    # ard_scale does (bit for bit for a kernel in x's dtype) and scales each
    # coordinate as ard_prescale does, so a call is one launch
    h = kernel.h.to(device=x1.device, dtype=x1.dtype)
    w = kernel.w.to(device=x1.device, dtype=x1.dtype).contiguous()
    diag = None if noise is None else _diag_term(noise, jitter, x1)
    if _wants_grad(x1, x2, h, w, diag):
        return _PairwiseArdK.apply(x1, x2, h, w, diag)
    return _launch_ard(x1, x2, h, w, diag)


class _PairwiseArdK(torch.autograd.Function):
    """Kernel B6 with its backward: B2a has no ARD case, so every gradient
    (h, w, the inputs) is autograd of the plain ARD element on the
    recomputed block, as the JAX package differentiates its ``jnp``
    kernel; the diagonal term's is tr(G)."""

    @staticmethod
    def forward(ctx, x1, x2, h, w, diag):
        x1, x2, h, w = x1.detach(), x2.detach(), h.detach(), w.detach()
        ctx.save_for_backward(x1, x2, h, w)
        ctx.with_diag = diag is not None
        return _launch_ard(x1, x2, h, w, None if diag is None else diag.detach())

    @staticmethod
    def backward(ctx, G):
        needs = ctx.needs_input_grad[:4]
        grads = [None] * 4
        if any(needs):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need)
                          for t, need in zip(ctx.saved_tensors, needs)]
                K = _ard_k(leaves[2], leaves[3], leaves[0], leaves[1])
                wanted = [t for t in leaves if t.requires_grad]
                got = iter(torch.autograd.grad(K, wanted, G))
            grads = [next(got) if need else None for need in needs]
        g_diag = torch.diagonal(G).sum() if ctx.needs_input_grad[4] else None
        return (*grads, g_diag)


def _launch_ard(x1, x2, h, w, diag) -> torch.Tensor:
    _check_cuda("pairwise_matrix_ard", x1, x2, h, w, *([] if diag is None else [diag]))
    (n, D), m = x1.shape, x2.shape[0]
    if max(n, m) > _INT32_MAX or D > _MAX_ARD_DIM:
        raise ValueError(f"pairwise_matrix_ard: n, m must fit in int32 and D <= "
                         f"{_MAX_ARD_DIM}, got {n}, {m}, {D}")
    out = torch.empty((n, m), dtype=x1.dtype, device=x1.device)
    if n == 0 or m == 0:
        return out
    status = _build.entry("gp_pairwise_ard", x1.dtype)(
        x1.device.index, x1.data_ptr(), x2.data_ptr(), h.data_ptr(), w.data_ptr(),
        None if diag is None else diag.data_ptr(), out.data_ptr(), n, m, D,
        _ARD_SCALE[x1.dtype], _build.stream_of(x1),
    )
    _build.check(status, "gp_pairwise_ard")
    _build.launch_counts["pairwise_ard"] += 1
    return out


def pairwise_matrix_ard_reference(kernel, x1, x2, *, noise=None, jitter=0.0) -> torch.Tensor:
    """Plain PyTorch twin of ``pairwise_matrix_ard`` (B6's oracle and CPU
    path): sum_d ((x1_d - x2_d) / w_d)^2 accumulated one dimension at a time,
    as the Pallas body does."""
    x1, x2 = _points(kernel, x1, x2)
    params = _params_like(kernel, x1)
    K = _ard_k(params[0], params[1:], x1, x2)
    if noise is not None:
        K.diagonal().add_(_diag_term(noise, jitter, x1))
    return K


def _ard_k(h, w, x1, x2) -> torch.Tensor:
    acc = x1.new_zeros((x1.shape[0], x2.shape[0]))
    for d in range(x1.shape[1]):
        acc = acc + torch.square((x1[:, d, None] - x2[None, :, d]) / w[d])
    return torch.square(h) * torch.exp(-0.5 * acc)


# ---------------------------------------------------------------------------
# B4, B5: matrix-free products
# ---------------------------------------------------------------------------


def _has_closed_form(kernel) -> bool:
    # a class-level int only, the counterpart of the JAX package's
    # `supports_tiled is True` gate: a family exposed as a property (as
    # composite kernels expose supports_tiled) is truthy on the class but
    # names no single closed form
    fam = getattr(type(kernel), "cuda_family", None)
    return isinstance(fam, int) and not isinstance(fam, bool)


def _is_closed_form_tree(kernel) -> bool:
    if not is_tree(kernel):
        return False
    try:
        _tree_structure(kernel)
    except TypeError:
        return False
    return True


def supports_fused_matvec(kernel, x) -> bool:
    """True when ``kernel_matvec_fused`` can run for this (kernel, x): a
    leaf with a closed form or a tree of them over 1-D x, ARD over (n, D)."""
    x = torch.as_tensor(x)
    if x.ndim == 2:
        return _is_ard(kernel)
    return x.ndim == 1 and (_has_closed_form(kernel) or _is_closed_form_tree(kernel))


def supports_fused_jacvec(kernel, x) -> bool:
    """True when ``kernel_jacvec_fused`` can run for this (kernel, x): leaves
    only, as the JAX package's gate (a tree's Jacobian is built at matrix
    level from its children)."""
    return torch.as_tensor(x).ndim == 1 and _has_closed_form(kernel)


def _rhs(x, v):
    v = torch.as_tensor(v, device=x.device)
    squeeze = v.ndim == 1
    v2 = v[:, None] if squeeze else v
    if v2.ndim != 2 or v2.shape[0] != x.shape[0]:
        raise ValueError(f"right-hand side {tuple(v.shape)} does not match x "
                         f"{tuple(x.shape)}")
    return v2, squeeze


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _product_splits(n: int, r: int, device, vals: int) -> int:
    """Column splits of a B4 (``vals`` = 1) or B5 (``vals`` = P) launch.  The
    rule lives beside the kernel, with the chunk of right-hand sides a block
    holds and the rows a thread owns (``splits_for``, csrc/matvec.cuh)."""
    return _build.library().gp_product_splits(vals, n, r, _sm_count(device.index))


def _launch_product(kernel, x, v, jac: bool) -> torch.Tensor:
    name = "gp_kernel_jacvec" if jac else "gp_kernel_matvec"
    v = v.contiguous()
    params = _params_like(kernel, x)
    _check_cuda(name, x, v, params)
    n, r = v.shape
    if max(n, r) > _INT32_MAX:
        raise ValueError(f"{name}: n, r must fit in int32, got {n}, {r}")
    vals = kernel.n_params if jac else 1
    out = torch.empty((vals, n, r) if jac else (n, r), dtype=x.dtype, device=x.device)
    if n == 0 or r == 0:
        return out.zero_()
    splits = _product_splits(n, r, x.device, vals)
    work = (torch.empty(splits * vals * n * r, dtype=x.dtype, device=x.device)
            if splits > 1 else None)
    family, tree, suffix = _launch_family(kernel)
    status = _build.entry(name, x.dtype)(
        x.device.index, x.data_ptr(), v.data_ptr(), params.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), n, r, family,
        *(() if jac else (tree,)), splits, _build.stream_of(x),
    )
    _build.check(status, name)
    _build.launch_counts[("kernel_jacvec" if jac else "kernel_matvec") + suffix] += 1
    return out


# B4, B5, B4-ARD and B6 fold every constant out of the element: with
# c^2 = log2(e) / 2 in float32 and 1 / 2 in float64, exp(-q / 2) is
# exp2(-c^2 q) (one ex2 instruction) or exp(-c^2 q), and c / w scales the
# difference (B4, B5: csrc/matvec.cuh) or the coordinates (B4-ARD:
# csrc/ard_matvec.cuh; B6: csrc/ard_pairwise.cu) once.
_FOLD_C2 = {torch.float32: 0.5 * math.log2(math.e), torch.float64: 0.5}
_ARD_SCALE = {dtype: math.sqrt(c2) for dtype, c2 in _FOLD_C2.items()}
# L in e^(-u) = base^(-L u): log2(e) for float32's exp2, 1 for float64's exp
# (the Matérn and RQ folds, fold_base in csrc/matvec.cuh)
_FOLD_BASE = {torch.float32: math.log2(math.e), torch.float64: 1.0}
_SQRT3, _SQRT5 = 1.7320508075688772, 2.23606797749979


# sin_reduced's constants (csrc/closed_forms.cuh): 1 / pi and pi as float(pi)
# plus the rest for float32's two FMAs; for float64 pi in three parts of at
# most 26 bits, so that k times the first two is exact in the plain version
_INV_PI = 1.0 / math.pi
_PI_F32 = (3.1415927410125732, -8.742278012618954e-08)
_PI_F64 = (3.1415926218032837, 3.1786509424591713e-08, 1.2246467991473532e-16)
# the sine's Taylor coefficients 1 / 3!, ..., 1 / 13!, signed, highest first
_SIN_COEFFS = tuple((-1) ** (k // 2) / math.factorial(k) for k in (13, 11, 9, 7, 5, 3))
# log2(1 + q)'s series coefficients (-1)^(k+1) / (k ln 2), k = 6 .. 1, and
# where lg2.approx takes over (log1p_base)
_LOG1P_COEFFS = tuple((-1) ** (k + 1) / (k * math.log(2.0)) for k in range(6, 0, -1))
_LOG1P_SERIES_BELOW = 0.0625


def _fma32(a, b, c):
    """fmaf(a, b, c) for float32 tensors, through float64: a b is exact there,
    so only the sum rounds (twice, to float64 and float32)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def sin_reduced(u: torch.Tensor) -> torch.Tensor:
    """+-sin(u) as the kernels' folded element takes it (``sin_reduced`` in
    csrc/closed_forms.cuh): k = rint(u / pi), r = u - k pi (float32: two
    FMAs with pi = float(pi) + rest, then sin r as its Taylor series to
    r^13, Horner in r^2; float64: three parts of pi, then sin r).  The sign
    is (-1)^k; the leaves take its square."""
    k = torch.round(u * _INV_PI)
    if u.dtype == torch.float64:
        a, b, c = _PI_F64
        return torch.sin(((u - k * a) - k * b) - k * c)
    r = _fma32(-k, torch.tensor(_PI_F32[0], dtype=u.dtype), u)
    r = _fma32(-k, torch.tensor(_PI_F32[1], dtype=u.dtype), r)
    r2 = r * r
    p = torch.full_like(r, _SIN_COEFFS[0])
    for coef in _SIN_COEFFS[1:]:
        p = p * r2 + coef
    return (r * r2) * p + r


def log1p_base(q: torch.Tensor) -> torch.Tensor:
    """log_base(1 + q), q >= 0, as the kernels' folded RQ element takes it
    (``log1p_base`` in csrc/closed_forms.cuh): float32, base 2, the series
    q (1 / ln 2 - q / (2 ln 2) + ... - q^5 / (6 ln 2)) below q = 1/16 and
    log2(1 + q) from there (the kernel's lg2.approx); float64 ln(1 + q)."""
    if q.dtype == torch.float64:
        return torch.log(1.0 + q)
    p = torch.full_like(q, _LOG1P_COEFFS[0])
    for coef in _LOG1P_COEFFS[1:]:
        p = p * q + coef
    return torch.where(q < _LOG1P_SERIES_BELOW, p * q, torch.log2(1.0 + q))


def _leaf_exponent(fam: int, d, th, dtype):
    """The folded leaf (csrc/closed_forms.cuh, ``*Fold``): its exponent e in
    neg_exp's base, its multiplier (None where it is 1) and h^2 in float64,
    from the leaf's float64 parameters ``th`` (scalars or broadcastable)."""
    h, w = th[0], th[1]
    if fam == 0:  # SE: e = t^2, t = d s
        e = torch.square(d * (math.sqrt(_FOLD_C2[dtype]) / w).to(dtype))
        return e, None, h * h
    if fam == 1:  # periodic: e = g^2, g = sin(d / 2p) 2s
        g = sin_reduced(d * (0.5 / th[2]).to(dtype)) * (2.0 * math.sqrt(_FOLD_C2[dtype]) / w).to(dtype)
        return g * g, None, h * h
    if fam in (2, 3):  # Matérn: e = t = |d| s, the polynomial in u = t / L
        base = _FOLD_BASE[dtype]
        t = torch.abs(d) * ((_SQRT3 if fam == 2 else _SQRT5) * base / w).to(dtype)
        u = t * (1.0 / base)
        return t, (1.0 + u) if fam == 2 else (1.0 + u * (1.0 + u * (1.0 / 3.0))), h * h
    # RQ: e = a log_base(1 + t^2), t = d s
    a = th[2]
    t = d * (1.0 / (w * torch.sqrt(2.0 * a))).to(dtype)
    return a.to(dtype) * log1p_base(t * t), None, h * h


def _folded_k(kernel, d, theta, dtype):
    """B1's and B4's element (the unscaled plane) and its float64 scale, for
    a leaf or a tree; ``theta`` the (P, ...) float64 parameters."""
    neg_exp = torch.exp2 if dtype == torch.float32 else torch.exp
    if not is_tree(kernel):
        e, mult, h2 = _leaf_exponent(_family(kernel), d, theta, dtype)
        E = neg_exp(-e)
        return (E if mult is None else mult * E), h2
    leaves, masks = _tree_flat(_tree_structure(kernel))
    parts = [_leaf_exponent(cls.cuda_family, d, theta[off:off + len(cls.param_names)], dtype)
             for cls, off in leaves]
    out, scale = None, None
    for mask in masks:
        E, M, c = torch.zeros((), dtype=dtype), torch.ones((), dtype=dtype), 1.0
        for bit, (e, mult, h2) in enumerate(parts):
            if mask >> bit & 1:
                E = E + e
                M = M if mult is None else M * mult
                c = c * h2
        k = M * neg_exp(-E)
        if len(masks) == 1:
            return k, c
        out = c.to(dtype) * k if out is None else out + c.to(dtype) * k
        scale = torch.ones_like(c)
    return out, scale


def folded_values(kernel, x1, x2, jac: bool = False):
    """B1's and B4's (``jac`` false) or B5's arithmetic per element in plain
    PyTorch: the unscaled (n, m) planes and the float64 constants that
    multiply each plane, ``k = scale[0] * planes[0]`` and ``dK/dtheta_p =
    scale[p] * planes[p]``.

    K is the folded element of csrc/closed_forms.cuh: a leaf's exponent e
    and multiplier m, m exp2(-e) in float32, m exp(-e) in float64, with
    c^2 = log2(e) / 2 or 1 / 2 and L = log2(e) or 1.  SE: e = t^2, t =
    (x1_i - x2_j) s, s = c / w.  Periodic: e = g^2, g = ``sin_reduced``((x1_i
    - x2_j) / 2p) 2s.  Matérn: e = t = |x1_i - x2_j| s, s = c' L / w (c' =
    sqrt(3), sqrt(5)), m = 1 + u or 1 + u (1 + u / 3), u = t / L.  RQ: e =
    a ``log1p_base``(t^2), t = (x1_i - x2_j) s, s = 1 / (w sqrt(2a)).  The
    scale is h^2.  A tree is a sum of products of its leaves (``_tree_flat``):
    per product the sum of its leaves' exponents in leaf order and the
    product of their multipliers, one exponential; one product is scaled by
    its leaves' h^2 (in float64) outside, several each by its own in the
    element (rounded to x's dtype) and the scale is 1.

    B5 (``jac``): SE planes E and E t^2; periodic E, E g^2, E d sin u cos u
    (u = d / 2p, accurate sin and cos); Matérn (1 + u) E or (1 + u (1 + u /
    3)) E and u^2 E or u^2 (1 + u) E; RQ B^-a, t^2 B^-a / B, B^-a (t^2 / B -
    ln B) with B = 1 + t^2 and log2 B or ln B.  The difference is taken
    first and then scaled: pre-scaled coordinates lose float32 digits where
    |x| / w is large."""
    x1, x2 = _vectors(x1, x2)
    dtype = x1.dtype
    theta = kernel.params.to(device=x1.device, dtype=torch.float64)
    d = pairwise_diff(x1, x2)
    if not jac:
        k, scale = _folded_k(kernel, d, theta, dtype)
        return [k], [torch.as_tensor(scale, dtype=torch.float64, device=x1.device)]
    c2 = _FOLD_C2[dtype]
    base = _FOLD_BASE[dtype]
    neg_exp = torch.exp2 if dtype == torch.float32 else torch.exp
    h, w = theta[0], theta[1]
    fam = _family(kernel)
    if fam in (2, 3):  # Matérn 3/2, 5/2
        c = _SQRT3 if fam == 2 else _SQRT5
        t = torch.abs(d) * (c * base / w).to(dtype)
        u = t * (1.0 / base)
        E = neg_exp(-t)
        poly = (1.0 + u) if fam == 2 else (1.0 + u * (1.0 + u * (1.0 / 3.0)))
        if fam == 2:
            return [poly * E, (u * u) * E], [2.0 * h, h * h / w]
        return [poly * E, ((u * u) * (1.0 + u)) * E], [2.0 * h, h * h / (3.0 * w)]
    if fam == 4:  # RQ
        a = theta[2]
        t = d * (1.0 / (w * torch.sqrt(2.0 * a))).to(dtype)
        t2 = t * t
        B = 1.0 + t2
        lb = torch.log2(B) if dtype == torch.float32 else torch.log(B)
        Ba = neg_exp(-(a.to(dtype) * lb))
        q = t2 / B
        return ([Ba, q * Ba, Ba * (q - lb * (1.0 / base))],
                [2.0 * h, 2.0 * h * h * a / w, h * h])
    s = (math.sqrt(c2) / w).to(dtype)
    if fam == 0:
        t2 = torch.square(d * s)
        E = neg_exp(-t2)
        return [E, E * t2], [2.0 * h, h * h / (c2 * w)]
    p = theta[2]
    u = d * (0.5 / p).to(dtype)
    sn = torch.sin(u)
    g2 = torch.square(sn * (2.0 * s))
    E = neg_exp(-g2)
    return ([E, E * g2, E * (d * (sn * torch.cos(u)))],
            [2.0 * h, h * h / (c2 * w), 2.0 * h * h / (w * w * p * p)])


def pairwise_matrix_folded(kernel, x1, x2, *, noise=None, jitter=0.0) -> torch.Tensor:
    """B1's own arithmetic in plain PyTorch (its oracle on the card): the
    folded element of ``folded_values`` times its scale rounded to x's
    dtype, as the kernel scales at the store, plus the diagonal term."""
    x1, x2 = _vectors(x1, x2)
    (k,), (scale,) = folded_values(kernel, x1, x2)
    K = k * scale.to(x1.dtype)
    if noise is not None:
        K.diagonal().add_(_diag_term(noise, jitter, x1))
    return K


def pairwise_matrix_chains_folded(kernel_template, x, params, diag) -> torch.Tensor:
    """B1's own arithmetic over a (C, P) chain table, as
    ``pairwise_matrix_folded`` for each chain: (C, n, n)."""
    x, _ = _vectors(x, x)
    params = _chain_params(kernel_template, x, params).to(torch.float64)
    theta = params.T[:, :, None, None]  # (P, C, 1, 1)
    k, scale = _folded_k(kernel_template, pairwise_diff(x, x)[None], theta, x.dtype)
    K = k * torch.as_tensor(scale, dtype=torch.float64, device=x.device).to(x.dtype)
    K.diagonal(dim1=-2, dim2=-1).add_(torch.as_tensor(diag, dtype=x.dtype,
                                                      device=x.device)[:, None])
    return K


def _folded_product(kernel, x, v, jac: bool, block_size: int) -> torch.Tensor:
    """(P, n, r) row sums of ``folded_values``' planes times v, each scaled
    once in float64, as the kernels scale their double row sums."""
    out = None
    for j in range(0, x.shape[0], block_size):
        planes, scale = folded_values(kernel, x, x[j:j + block_size], jac)
        part = torch.stack([plane @ v[j:j + block_size] for plane in planes])
        out = part if out is None else out + part
    scale = torch.stack(scale)[:, None, None]
    return (out.double() * scale).to(x.dtype)


def matvec_folded_reference(kernel, x, v, block_size=1024) -> torch.Tensor:
    """K(x, x) V with B4's arithmetic (``folded_values``), without the noise
    term, for leaf closed-form kernels and trees over 1-D x."""
    x = torch.as_tensor(x)
    v2, squeeze = _rhs(x, v)
    out = _folded_product(kernel, x, v2, False, block_size)[0]
    return out[:, 0] if squeeze else out


def jacvec_folded_reference(kernel, x, u, block_size=1024) -> torch.Tensor:
    """The (P, n, r) stack of dK/dtheta_p U with B5's arithmetic."""
    x = torch.as_tensor(x)
    u2, _ = _rhs(x, u)
    return _folded_product(kernel, x, u2, True, block_size)


# B4-ARD takes coordinates pre-scaled by c / w_d, so that a dimension costs a
# subtract and an FMA and k = h^2 exp2(-sq) (float32) or h^2 exp(-sq)
# (float64) (csrc/ard_matvec.cuh).
#: blocks per SM that the column splits of a B4-ARD launch aim for
_ARD_BLOCKS_PER_SM = 16


def ard_scale(kernel, x: torch.Tensor) -> torch.Tensor:
    """(D,) factors c / w_d in x's dtype, c = ``_ARD_SCALE``, each rounded
    once from float64."""
    w = kernel.w.to(device=x.device, dtype=torch.float64)
    return (_ARD_SCALE[x.dtype] / w).to(x.dtype)


def ard_prescale(kernel, x: torch.Tensor) -> torch.Tensor:
    """(n, D) coordinates x_d * c / w_d in x's dtype (``ard_scale``)."""
    return (x * ard_scale(kernel, x)).contiguous()


def pairwise_ard_prescaled_reference(h, xs1, xs2, *, diag=None) -> torch.Tensor:
    """ARD-SE K with B6's arithmetic, on coordinates pre-scaled by
    ``ard_prescale``: h^2 exp2(-sq) in float32, h^2 exp(-sq) in float64,
    sq = sum_d (xs1_d - xs2_d)^2 taken one dimension at a time, plus
    ``diag`` on the global diagonal when given.  B4-ARD's entries are the
    same (``ard_matvec_prescaled_reference``)."""
    h2 = torch.square(torch.as_tensor(h, dtype=xs1.dtype, device=xs1.device))
    neg_exp = torch.exp2 if xs1.dtype == torch.float32 else torch.exp
    sq = xs1.new_zeros((xs1.shape[0], xs2.shape[0]))
    for d in range(xs1.shape[1]):
        sq = sq + torch.square(xs1[:, d, None] - xs2[None, :, d])
    K = h2 * neg_exp(-sq)
    if diag is not None:
        K.diagonal().add_(torch.as_tensor(diag, dtype=K.dtype, device=K.device))
    return K


def ard_matvec_prescaled_reference(h, xs, v, block_size=1024) -> torch.Tensor:
    """K V with B4-ARD's arithmetic on pre-scaled coordinates ``xs``
    (``ard_prescale``): h^2 (exp2(-sq) V) in float32, h^2 (exp(-sq) V) in
    float64, sq = sum_d (xs_i - xs_j)^2 taken one dimension at a time."""
    v2, squeeze = _rhs(xs, v)
    h2 = torch.square(torch.as_tensor(h, dtype=xs.dtype, device=xs.device))
    out = v2.new_zeros(v2.shape)
    for j in range(0, xs.shape[0], block_size):
        E = pairwise_ard_prescaled_reference(1.0, xs, xs[j:j + block_size])
        out += E @ v2[j:j + block_size]
    out = h2 * out
    return out[:, 0] if squeeze else out


def _ard_splits(n: int, r: int, device) -> int:
    """Column splits of a B4-ARD launch: about ``_ARD_BLOCKS_PER_SM`` blocks
    per SM (a block covers 1024 rows and 1 right-hand side, 512 rows and 8,
    or 256 rows and a chunk of 16), with at least 4 tiles of 128 columns per
    split."""
    chunk, rows = (1, 1024) if r == 1 else (8, 512) if r <= 8 else (16, 256)
    blocks = -(-n // rows) * -(-r // chunk)
    want = -(-_ARD_BLOCKS_PER_SM * _sm_count(device.index) // blocks)
    return max(1, min(want, -(-n // 512)))


def _launch_ard_product(kernel, x, v) -> torch.Tensor:
    v = v.contiguous()
    h = _params_like(kernel, x)[:1]
    _check_cuda("gp_ard_matvec", x, v, h)
    xs = ard_prescale(kernel, x)
    (n, D), r = xs.shape, v.shape[1]
    if max(n, r) > _INT32_MAX or D > _MAX_ARD_DIM:
        raise ValueError(f"gp_ard_matvec: n, r must fit in int32 and D <= {_MAX_ARD_DIM}, "
                         f"got {n}, {r}, {D}")
    out = torch.empty((n, r), dtype=x.dtype, device=x.device)
    if n == 0 or r == 0:
        return out.zero_()
    splits = _ard_splits(n, r, x.device)
    work = torch.empty(splits * n * r, dtype=x.dtype, device=x.device) if splits > 1 else None
    status = _build.entry("gp_ard_matvec", x.dtype)(
        x.device.index, xs.data_ptr(), v.data_ptr(), h.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), n, D, r, splits, _build.stream_of(x),
    )
    _build.check(status, "gp_ard_matvec")
    _build.launch_counts["kernel_matvec_ard"] += 1
    return out


def kernel_matvec_fused(kernel, x, v, noise, jitter: float = 0.0) -> torch.Tensor:
    """(K(x, x) + (noise^2 + jitter) I) @ v with K never stored; v is (n,) or
    (n, r).  Leaf closed-form kernels and Sum/Product trees of them over 1-D
    x and ``ARDGaussianKernel`` over (n, D) x.  The CUDA path is kernel B4
    (its tree body for a tree; B4-ARD); the noise term is added outside it."""
    x = torch.as_tensor(x)
    if not supports_fused_matvec(kernel, x):
        raise TypeError(f"no fused matvec for {type(kernel).__name__} over inputs "
                        f"of shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return kernel_matvec_fused_reference(kernel, x, v, noise, jitter)
    if x.device.type != "cuda":
        raise _unsupported(x)
    v2, squeeze = _rhs(x, v)
    if x.ndim == 2:
        out = _launch_ard_product(kernel, x.contiguous(), v2)
    else:
        out = _launch_product(kernel, x.contiguous(), v2, jac=False)
    out = out + _diag_term(noise, jitter, x) * v2
    return out[:, 0] if squeeze else out


def kernel_matvec_fused_reference(kernel, x, v, noise, jitter=0.0, block_size=1024) -> torch.Tensor:
    """Plain PyTorch twin of ``kernel_matvec_fused``: (n, b) strips of K from
    the plain builders, each contracted with ``torch.matmul``."""
    x = torch.as_tensor(x)
    v2, squeeze = _rhs(x, v)
    build = pairwise_matrix_ard_reference if x.ndim == 2 else pairwise_matrix_reference
    out = v2.new_zeros(v2.shape)
    for j in range(0, x.shape[0], block_size):
        out += build(kernel, x, x[j:j + block_size]) @ v2[j:j + block_size]
    out = out + _diag_term(noise, jitter, x) * v2
    return out[:, 0] if squeeze else out


def kernel_jacvec_fused(kernel, x, u) -> torch.Tensor:
    """(P, n, r) = stack_p(dK/dtheta_p @ u) without storing dK/dtheta.  Leaf
    closed-form kernels over 1-D x only.  The CUDA path is kernel B5."""
    x = torch.as_tensor(x)
    if x.ndim != 1:
        raise TypeError("fused jacvec is 1-D-input only")
    if not _has_closed_form(kernel):
        raise TypeError(f"{type(kernel).__name__} has no static closed-form jac_fn")
    if x.device.type == "cpu":
        return kernel_jacvec_fused_reference(kernel, x, u)
    if x.device.type != "cuda":
        raise _unsupported(x)
    u2, _ = _rhs(x, u)
    return _launch_product(kernel, x.contiguous(), u2, jac=True)


def kernel_jacvec_fused_reference(kernel, x, u, block_size=1024) -> torch.Tensor:
    """Plain PyTorch twin of ``kernel_jacvec_fused``: (P, n, b) Jacobian
    strips from the plain builder, each contracted with ``torch.matmul``."""
    x = torch.as_tensor(x)
    u2, _ = _rhs(x, u)
    out = u2.new_zeros((kernel.n_params, *u2.shape))
    for j in range(0, x.shape[0], block_size):
        out += pairwise_jacobian_reference(kernel, x, x[j:j + block_size]) @ u2[j:j + block_size]
    return out
