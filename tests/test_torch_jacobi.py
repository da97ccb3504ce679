"""The port's Jacobi stencil (``repro_torch.kernels.jacobi`` and
``repro_torch.stencil.jacobi``) held against the JAX package.

Inputs come from a numpy seed and the same arrays go to both sides.  On the
CPU the port's wrappers run their plain versions; the tests marked ``cuda``
hold the Hopper kernels against those plain versions on the card and skip
without one.

Tolerances: the plain sweep sums the six neighbours in the reference's
order in f32, so any gap is reassociation by the backend only (atol 1e-6
on unit-normal inputs); the two-step composes two such sweeps against the
Pallas kernel's own assembly of the halo (atol 1e-5, the reference's own
tolerance for that kernel).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jacobi import ops as jax_ops
from repro.kernels.jacobi import ref as jax_ref
from repro.kernels.jacobi.kernel import jacobi_sweep_pallas
from repro.kernels.jacobi.temporal import jacobi_two_step_pallas
from repro.stencil import jacobi as jax_stencil
from repro_torch.kernels.jacobi import ops, ref
from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
from repro_torch.kernels.jacobi.temporal import jacobi_two_step_cuda
from repro_torch.stencil import jacobi as stencil

# tests/test_kernels.py's shapes for each kernel
SWEEP_CASES = [
    ((20, 20, 60), (10, 10)),
    ((8, 16, 128), (4, 8)),
    ((10, 10, 600), (10, 10)),     # the paper's block geometry
    ((30, 20, 32), (10, 5)),
    ((4, 4, 16), (2, 2)),
]
TWO_STEP_CASES = [
    ((20, 20, 32), (5, 5)),
    ((12, 8, 16), (4, 4)),
    ((10, 10, 600), (10, 10)),
    ((8, 8, 8), (2, 2)),
]


def _lattice(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


class TestPlainVersions:
    @pytest.mark.parametrize("c", [1 / 6, 0.25])
    @pytest.mark.parametrize("shape,block", SWEEP_CASES)
    def test_sweep_ref_matches_jax_ref(self, shape, block, c):
        f = _lattice(shape)
        got = ref.jacobi_sweep_ref(torch.from_numpy(f), c).numpy()
        want = np.asarray(jax_ref.jacobi_sweep_ref(jnp.asarray(f), c))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("shape,block", SWEEP_CASES)
    def test_kernel_wrapper_on_cpu_matches_pallas(self, shape, block):
        f = _lattice(shape, seed=1)
        before = jacobi_sweep_cuda.launches
        got = jacobi_sweep_cuda(torch.from_numpy(f), 1 / 6, *block).numpy()
        want = np.asarray(jacobi_sweep_pallas(jnp.asarray(f), 1 / 6, *block,
                                              interpret=True))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert jacobi_sweep_cuda.launches == before   # plain version: no launch

    @pytest.mark.parametrize("shape,block", TWO_STEP_CASES)
    def test_two_step_matches_pallas(self, shape, block):
        f = _lattice(shape, seed=2)
        before = jacobi_two_step_cuda.launches
        got = jacobi_two_step_cuda(torch.from_numpy(f), 1 / 6, *block).numpy()
        want = np.asarray(jacobi_two_step_pallas(jnp.asarray(f), 1 / 6, *block,
                                                 interpret=True))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert jacobi_two_step_cuda.launches == before

    def test_two_step_ref_is_two_sweeps(self):
        f = _lattice((8, 8, 16), seed=3)
        got = ref.jacobi_two_step_ref(torch.from_numpy(f), 0.25).numpy()
        once = jax_ref.jacobi_sweep_ref(jnp.asarray(f), 0.25)
        want = np.asarray(jax_ref.jacobi_sweep_ref(once, 0.25))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_block_ref_matches_jax(self):
        f = _lattice((20, 20, 16), seed=4)
        got = ref.jacobi_block_ref(torch.from_numpy(f), 10, 5, 10, 5).numpy()
        want = np.asarray(jax_ref.jacobi_block_ref(jnp.asarray(f), 10, 5, 10, 5))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class TestContract:
    @pytest.mark.parametrize("shape,block", [((9, 8, 16), (4, 4)),
                                             ((8, 9, 16), (4, 4))])
    def test_sweep_rejects_indivisible_like_reference(self, shape, block):
        with pytest.raises(ValueError) as want:
            jax_ops.jacobi_sweep(jnp.zeros(shape, jnp.float32), di=block[0],
                                 dj=block[1], use_pallas=True)
        with pytest.raises(ValueError) as got:
            ops.jacobi_sweep(torch.zeros(shape), di=block[0], dj=block[1],
                             use_kernel=True)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("shape,block", [((9, 8, 16), (4, 4)),
                                             ((4, 4, 8), (1, 1))])
    def test_two_step_rejects_like_reference(self, shape, block):
        with pytest.raises(ValueError) as want:
            jacobi_two_step_pallas(jnp.zeros(shape, jnp.float32), di=block[0],
                                   dj=block[1])
        with pytest.raises(ValueError) as got:
            jacobi_two_step_cuda(torch.zeros(shape), di=block[0], dj=block[1])
        assert str(got.value) == str(want.value)

    def test_plain_path_ignores_blocks(self):
        f = torch.from_numpy(_lattice((9, 7, 5), seed=5))
        got = ops.jacobi_sweep(f, use_kernel=False).numpy()
        want = np.asarray(jax_ops.jacobi_sweep(jnp.asarray(f.numpy()),
                                               use_pallas=False))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("bad,err", [
        (torch.zeros(4, 4), ValueError),
        (torch.zeros(4, 4, 4, dtype=torch.float64), TypeError),
    ])
    def test_wrappers_check_inputs(self, bad, err):
        with pytest.raises(err):
            jacobi_sweep_cuda(bad, di=2, dj=2)
        with pytest.raises(err):
            jacobi_two_step_cuda(bad, di=2, dj=2)

    def test_row_range_writes_in_place(self):
        f = torch.from_numpy(_lattice((12, 6, 8), seed=6))
        out = torch.full((10, 6, 8), float("nan"))
        got = jacobi_sweep_cuda(f, 0.25, di=12, dj=6, out=out, rows=(1, 11))
        assert got is out
        want = np.asarray(jax_ref.jacobi_sweep_ref(jnp.asarray(f.numpy()), 0.25))
        np.testing.assert_allclose(out.numpy(), want[1:11], rtol=0, atol=1e-6)

    @pytest.mark.parametrize("rows,shape", [((0, 13), (13, 6, 8)),
                                            ((2, 5), (4, 6, 8))])
    def test_row_range_rejects_bad_rows_or_out(self, rows, shape):
        f = torch.zeros(12, 6, 8)
        with pytest.raises(ValueError):
            jacobi_sweep_cuda(f, di=12, dj=6, rows=rows, out=torch.zeros(shape))


class TestIterate:
    @pytest.mark.parametrize("steps", [0, 1, 3])
    def test_matches_reference_scan(self, steps):
        f = _lattice((20, 20, 16), seed=7)
        ft = torch.from_numpy(f.copy())
        got = ops.jacobi_iterate(ft, steps, 0.25).numpy()
        want = np.asarray(jax_ops.jacobi_iterate(jnp.asarray(f), steps, 0.25))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ft.numpy(), f)     # input untouched

    def test_plain_path_any_shape(self):
        f = _lattice((7, 9, 5), seed=8)
        got = ops.jacobi_iterate(torch.from_numpy(f), 4, use_kernel=False)
        want = jax_ops.jacobi_iterate(jnp.asarray(f), 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


class TestStencilHelpers:
    def test_grid_config_matches(self):
        assert (dataclasses.asdict(stencil.JacobiGridConfig())
                == dataclasses.asdict(jax_stencil.JacobiGridConfig()))
        assert stencil.paper_flops_per_site() == jax_stencil.paper_flops_per_site()

    @pytest.mark.parametrize("n_dev,bpd", [(2, 3), (4, 2), (1, 5)])
    def test_scatter_and_reassemble_match(self, n_dev, bpd):
        f = _lattice((n_dev * bpd * 3, 4, 5), seed=9)
        got = stencil.scatter_lattice(torch.from_numpy(f), n_dev, bpd)
        want = jax_stencil.scatter_lattice(jnp.asarray(f), n_dev, bpd)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = stencil.reassemble_scattered(got, n_dev, bpd)
        np.testing.assert_array_equal(back.numpy(), f)


@pytest.mark.cuda
class TestOnCard:
    """The Hopper kernels against their plain versions on the card."""

    @pytest.mark.parametrize("c", [1 / 6, 0.25])
    @pytest.mark.parametrize("shape,block", SWEEP_CASES)
    def test_sweep_kernel(self, cuda, shape, block, c):
        f = torch.from_numpy(_lattice(shape)).to(cuda)
        before = jacobi_sweep_cuda.launches
        got = jacobi_sweep_cuda(f, c, *block)
        torch.cuda.synchronize()
        assert jacobi_sweep_cuda.launches == before + 1
        torch.testing.assert_close(got, ref.jacobi_sweep_ref(f, c), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("c", [1 / 6, 0.25])
    @pytest.mark.parametrize("shape,block", TWO_STEP_CASES)
    def test_two_step_kernel(self, cuda, shape, block, c):
        f = torch.from_numpy(_lattice(shape)).to(cuda)
        got = jacobi_two_step_cuda(f, c, *block)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.jacobi_two_step_ref(f, c), rtol=0,
                                   atol=1e-5)

    def test_runtime_sweep_launches_one_kernel_per_slab(self, cuda):
        f = torch.from_numpy(_lattice((40, 12, 24))).to(cuda)
        before = jacobi_sweep_cuda.launches
        out, stats = stencil.run_runtime_sweep(f, di=5, num_domains=4,
                                               workers_per_domain=2)
        torch.cuda.synchronize()
        assert jacobi_sweep_cuda.launches - before == 8 == stats.executed
        torch.testing.assert_close(out, ref.jacobi_sweep_ref(f), rtol=0, atol=1e-6)

    def test_cuda_tensor_never_takes_plain_path(self, cuda):
        f = torch.zeros((9, 8, 16), device=cuda)
        with pytest.raises(ValueError):
            ops.jacobi_sweep(f, di=4, dj=4)
        with pytest.raises(ValueError):
            jacobi_sweep_cuda(f[:, :, ::2], di=9, dj=8)   # not contiguous
