"""Indexing of the port's operators against the JAX package on the CPU, in
float64 at 1e-10: ``normalize_getitem_index`` over ints, slices, ``None``,
the ellipsis and index tensors on batched operators (lazy where the JAX
package stays lazy), the kernel operator's ``_getitem`` and
``_select_rows``, which stay kernel operators and keep the fused mat-vec,
and ``sliced_shape``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linear_operator_tpu as jlo
import linear_operator_tpu_torch as tlo
from linear_operator_tpu.operators.kernel import rbf_kernel_operator as j_rbf
from linear_operator_tpu.utils.getitem import sliced_shape as j_sliced_shape
from linear_operator_tpu_torch.utils.getitem import sliced_shape as t_sliced_shape
from test_torch_harness_common import close, jx, normal, positive, psd, one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_structure import _jit


def tt(a):
    a = np.asarray(a)
    return torch.tensor(a, dtype=torch.float64) if a.dtype.kind == "f" else torch.tensor(a)


def _ops(kind):
    """The same batched (2, 3, 5, 5) operator in both packages."""
    a = psd(1, 2, 3, n=5)
    if kind == "dense":
        return jlo.DenseLinearOperator(jx(a)), tlo.DenseLinearOperator(tt(a))
    if kind == "constant_mul":
        c = positive(2, 3)
        return (
            jlo.ConstantMulLinearOperator(jlo.DenseLinearOperator(jx(a)), jx(c)),
            tlo.ConstantMulLinearOperator(tlo.DenseLinearOperator(tt(a)), tt(c)),
        )
    if kind == "diag":
        d = positive(4, 2, 3, 5)
        return jlo.DiagLinearOperator(jx(d)), tlo.DiagLinearOperator(tt(d))
    if kind == "triangular":
        lt = np.tril(a)
        return (
            jlo.TriangularLinearOperator(jlo.DenseLinearOperator(jx(lt))),
            tlo.TriangularLinearOperator(tlo.DenseLinearOperator(tt(lt))),
        )
    raise ValueError(kind)


# (label, index builder taking a converter for index tensors)
INDICES = [
    ("int", lambda T: 1),
    ("int_int", lambda T: (1, 2)),
    ("batch_slice", lambda T: (slice(0, 1), slice(1, 3))),
    ("ellipsis_rows", lambda T: (Ellipsis, slice(1, 4), slice(None))),
    ("ellipsis_cols_step", lambda T: (Ellipsis, slice(None), slice(0, 5, 2))),
    ("principal_block", lambda T: (Ellipsis, slice(1, 4), slice(1, 4))),
    ("int_row", lambda T: (Ellipsis, 1, slice(None))),
    ("int_entry", lambda T: (Ellipsis, 1, 2)),
    ("none_front", lambda T: (None,)),
    ("none_middle", lambda T: (slice(None), None)),
    ("rows_tensor", lambda T: (Ellipsis, T([0, 3, 1]), slice(None))),
    ("cols_tensor", lambda T: (Ellipsis, slice(None), T([4, 0]))),
    ("pointwise", lambda T: (Ellipsis, T([0, 1, 1]), T([1, 0, 2]))),
    ("batch_tensor", lambda T: (T([1, 0]),)),
    ("batch_tensor_int", lambda T: (T([1, 0]), 2)),
    ("int_batch_tensor", lambda T: (1, T([2, 0]))),
    ("batch_tensors_pointwise", lambda T: (T([1, 0]), T([2, 0]), T([0, 1]), T([3, 3]))),
    ("batch_tensor_matrix_tensor", lambda T: (T([1, 0]), slice(None), T([0, 4]), slice(None))),
    ("bool_mask", lambda T: (Ellipsis, T(np.array([True, False, True, True, False])), slice(None))),
    ("negative_int", lambda T: (-1, -1)),
]


@pytest.mark.parametrize("kind", ["dense", "constant_mul", "diag", "triangular"])
@pytest.mark.parametrize("label, build", INDICES, ids=[c[0] for c in INDICES])
def test_getitem_matches_jax(kind, label, build):
    j, t = _ops(kind)
    rj = j[build(lambda a: jnp.asarray(np.asarray(a)))]
    rt = t[build(lambda a: torch.as_tensor(np.asarray(a)))]
    assert isinstance(rt, tlo.LinearOperator) == isinstance(rj, jlo.LinearOperator), (type(rt), type(rj))
    dj = rj.to_dense() if isinstance(rj, jlo.LinearOperator) else rj
    dt = rt.to_dense() if isinstance(rt, tlo.LinearOperator) else rt
    close(dt, dj)
    # and against the dense matrix itself (torch semantics)
    dense = t.to_dense()[build(lambda a: torch.as_tensor(np.asarray(a)))]
    close(dt, dense)


def test_index_lists_and_numpy_ints():
    j, t = _ops("dense")
    close(t[[1, 0]].to_dense(), j[[1, 0]].to_dense())
    close(t[np.int64(1), np.int32(2)].to_dense(), j[1, 2].to_dense())
    close(t[..., np.array([0, 2]), :].to_dense(), j[..., np.array([0, 2]), :].to_dense())


def test_negative_step_slices():
    a = normal(7, 5, 6)
    t = tlo.DenseLinearOperator(tt(a))
    close(t[::-1, :].to_dense(), a[::-1, :])
    close(t[:, 4::-2].to_dense(), a[:, 4::-2])
    close(t[::-1, ::-1].to_dense(), a[::-1, ::-1])
    close(t[[0, 2], ::-1].to_dense(), a[[0, 2], ::-1])


def test_newaxis():
    d = psd(73)
    j, t = jlo.DenseLinearOperator(jx(d)), tlo.DenseLinearOperator(tt(d))
    assert tuple(t[None].shape) == (1, 6, 6)
    close(t[None].to_dense(), j[None].to_dense())
    d3 = psd(74, 3)
    j, t = jlo.DenseLinearOperator(jx(d3)), tlo.DenseLinearOperator(tt(d3))
    assert tuple(t[:, None].shape) == (3, 1, 6, 6)
    close(t[:, None].to_dense(), j[:, None].to_dense())


@pytest.mark.parametrize(
    "shape, index",
    [
        ((2, 3, 5, 4), (0, slice(None), slice(1, 3), slice(None))),
        ((2, 3, 5, 4), (slice(None), np.array([0, 2]), slice(None), slice(None))),
        ((2, 3, 5, 4), (np.array([1, 0]), slice(None), np.array([0, 4]), slice(None))),
        ((2, 3, 5, 4), (np.array([[1], [0]]), np.array([0, 2]), slice(0, 2), slice(None))),
    ],
)
def test_sliced_shape_matches_jax(shape, index):
    t_index = tuple(torch.as_tensor(i) if isinstance(i, np.ndarray) else i for i in index)
    assert t_sliced_shape(shape, *t_index) == j_sliced_shape(shape, *index)


# ---------------------------------------------------------------------------
# The kernel operator under indexing
# ---------------------------------------------------------------------------

X = normal(20, 40, 3)
ROWS = np.random.default_rng(21).permutation(40)[:9]


def _kernels(fused=False):
    j = j_rbf(jx(X), lengthscale=jnp.asarray(0.9), outputscale=jnp.asarray(1.3))
    t = tlo.rbf_kernel_operator(tt(X), lengthscale=0.9, outputscale=1.3, use_fused_kernels=fused)
    return j, t


@pytest.mark.parametrize(
    "label, index",
    [
        ("rows", (slice(3, 20), slice(None))),
        ("principal", (slice(5, 30), slice(5, 30))),
        ("strided", (slice(0, 40, 3), slice(1, 37, 2))),
        ("selected_rows", (ROWS, slice(None))),
        ("selected_cols", (slice(None), ROWS)),
    ],
)
def test_kernel_sub_operators_stay_kernel_operators(label, index):
    j, t = _kernels()
    rj = j[tuple(jnp.asarray(i) if isinstance(i, np.ndarray) else i for i in index)]
    rt = t[tuple(torch.as_tensor(i) if isinstance(i, np.ndarray) else i for i in index)]
    assert type(rt) is tlo.KernelLinearOperator and type(rj).__name__ == "KernelLinearOperator"
    assert rt.symmetric == rj.symmetric == (label == "principal")
    close(rt.to_dense(), rj.to_dense())
    rhs = normal(22, rt.shape[-1], 3)
    close(rt @ tt(rhs), rj.to_dense() @ jx(rhs))  # the JAX product contracts at Precision.HIGH
    close(rt._diagonal(), jnp.diagonal(rj.to_dense()))


def test_kernel_batch_indices_and_pointwise():
    xb = normal(23, 2, 10, 3)
    ls = positive(24, 2, 1, 1)
    j = jlo.KernelLinearOperator(
        jx(xb), jx(xb), {"lengthscale": jx(ls), "outputscale": jnp.asarray(1.1)},
        covar_func=jlo.operators.kernel.rbf_covar, symmetric=True,
    )
    t = tlo.KernelLinearOperator(
        tt(xb), tt(xb), {"lengthscale": tt(ls), "outputscale": torch.tensor(1.1, dtype=torch.float64)},
        covar_func=tlo.operators.rbf_covar, symmetric=True,
    )
    i, k = np.array([0, 3, 9]), np.array([1, 1, 4])
    # a batch slice is refused by the JAX package here: it indexes the 0-d
    # outputscale as a batched one (ROADMAP queue 3); its other answers come
    # from one compiled call
    want = _jit(lambda op: (op[1].to_dense(), op[1, 2:8, 2:8].to_dense(), op[1, jnp.asarray(i), jnp.asarray(k)]))(j)
    for index in [(1,), (1, slice(2, 8), slice(2, 8)), (slice(None), slice(0, 4), slice(3, 9))]:
        rt = t[index]
        assert type(rt) is tlo.KernelLinearOperator
        close(rt.to_dense(), t.to_dense()[index])
    close(t[1].to_dense(), want[0])
    close(t[1, 2:8, 2:8].to_dense(), want[1])
    close(t[1, torch.as_tensor(i), torch.as_tensor(k)], want[2])


@pytest.mark.parametrize(
    "index, wrapper",
    [
        ((ROWS, slice(None)), "kernel_matvec"),
        ((slice(4, 33), slice(None)), "kernel_matvec"),
        ((slice(4, 33), slice(4, 33)), "kernel_matvec_sym"),
    ],
)
def test_fused_sub_operators_keep_the_fused_matvec(index, wrapper, monkeypatch):
    """On the card these launch K1 (a rectangular sub-operator) and K3 (a
    principal block); on the CPU the same wrappers run their plain versions,
    in float32, as the card's kernels do."""
    _, plain = _kernels(fused=False)
    _, fused = _kernels(fused=True)
    index = tuple(torch.as_tensor(i) if isinstance(i, np.ndarray) else i for i in index)
    sub, sub_plain = fused[index], plain[index]
    assert sub.matvec_impl is not None
    calls = []
    from linear_operator_tpu_torch.operators import kernel as t_kernel

    real = getattr(t_kernel, wrapper)
    monkeypatch.setattr(t_kernel, wrapper, lambda *a, **k: calls.append(1) or real(*a, **k))
    for t in (1, 11):
        rhs = tt(normal(25 + t, sub.shape[-1], t))
        got = sub @ rhs
        close(got, sub_plain @ rhs, tol=1e-6)
    assert len(calls) == 2


def test_select_cols_keeps_the_blocked_path():
    """The Nystrom preconditioner takes its landmark columns through
    ``_select_cols``, in full precision."""
    _, fused = _kernels(fused=True)
    sub = fused[:, torch.as_tensor(ROWS)]
    assert type(sub) is tlo.KernelLinearOperator and sub.matvec_impl is None
    j, _ = _kernels()
    close(sub.to_dense(), j[:, jnp.asarray(ROWS)].to_dense())
