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
from repro_torch.kernels.jacobi import kernel, ops, ref
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

    def test_instance_launch_takes_only_card_tensors(self):
        """``kernel.launch`` (the sweep's and the tests' way to every compiled
        instance) has no plain version: CPU tensors raise before any build."""
        f = torch.zeros(4, 4, 8)
        with pytest.raises(ValueError):
            kernel.launch(False, 0, 10, f, torch.zeros(4, 4, 8))

    def test_row_range_writes_in_place(self):
        f = torch.from_numpy(_lattice((12, 6, 8), seed=6))
        out = torch.full((10, 6, 8), float("nan"))
        got = jacobi_sweep_cuda(f, 0.25, di=12, dj=6, out=out, rows=(1, 11))
        assert got is out
        want = np.asarray(jax_ref.jacobi_sweep_ref(jnp.asarray(f.numpy()), 0.25))
        np.testing.assert_allclose(out.numpy(), want[1:11], rtol=0, atol=1e-6)

    @pytest.mark.parametrize("rows", [(0, 3), (2, 5), (9, 12), (0, 12), (4, 4),
                                      (11, 12)])
    def test_row_range_sweeps_only_its_rows(self, rows, monkeypatch):
        """The plain row range equals the whole-lattice sweep's rows bit for
        bit, and sweeps no more than the rows and their two halo planes."""
        f = torch.from_numpy(_lattice((12, 5, 7), seed=10))
        swept = []

        def counted(x, c):
            swept.append(x.shape[0])
            return ref.jacobi_sweep_ref(x, c)

        monkeypatch.setattr(kernel, "jacobi_sweep_ref", counted)
        out = torch.full((rows[1] - rows[0], 5, 7), float("nan"))
        jacobi_sweep_cuda(f, 0.25, di=12, dj=5, out=out, rows=rows)
        assert torch.equal(out, ref.jacobi_sweep_ref(f, 0.25)[rows[0]:rows[1]])
        assert swept == [min(rows[1] + 1, 12) - max(rows[0] - 1, 0)]

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

    # K1 and K2 bit for bit against the plain sweep at j and k extents one
    # below, at and one above a tile (and 4 either side of it in k: TMA with
    # a ragged tile; 119 and 121 take the 4-byte copies), over 2 tiles in j
    @pytest.mark.parametrize("two_step", [False, True])
    @pytest.mark.parametrize("dk", [-4, -1, 0, 1, 4])
    @pytest.mark.parametrize("dj", [-1, 0, 1])
    def test_bit_exact_at_tile_edges(self, cuda, two_step, dj, dk):
        g = kernel.geometry(two_step)
        for tiles_j in (1, 2):
            f = torch.from_numpy(_lattice((7, tiles_j * g["tj"] + dj, g["tk"] + dk),
                                          seed=11)).to(cuda)
            self._check_bit_exact(f, two_step)

    @staticmethod
    def _check_bit_exact(f, two_step, c=1 / 6, rows=None):
        block = f.shape[:2]         # divides the lattice (the contract's check)
        if two_step:
            got = jacobi_two_step_cuda(f, c, *block)
            want = ref.jacobi_two_step_ref(f, c)
        elif rows is None:
            got = jacobi_sweep_cuda(f, c, *block)
            want = ref.jacobi_sweep_ref(f, c)
        else:
            got = jacobi_sweep_cuda(f, c, *block, rows=rows)
            want = ref.jacobi_sweep_ref(f, c)[rows[0]:rows[1]]
        torch.cuda.synchronize()
        unequal = int((got != want).sum())
        assert unequal == 0, f"{unequal} unequal elements at {tuple(f.shape)}"

    @pytest.mark.parametrize("two_step", [False, True])
    @pytest.mark.parametrize("shape", [(3, 2, 8), (2, 2, 4), (2, 3, 5), (4, 4, 16),
                                       (6, 10, 30), (5, 9, 13), (3, 7, 1)])
    def test_bit_exact_below_one_tile_and_ragged_k(self, cuda, two_step, shape):
        """Lattices smaller than one tile; nk not a multiple of 4 (the
        4-byte-copy instance)."""
        f = torch.from_numpy(_lattice(shape, seed=12)).to(cuda)
        self._check_bit_exact(f, two_step, c=0.25)

    @pytest.mark.parametrize("nk", [120, 30])
    def test_row_ranges_at_both_lattice_edges(self, cuda, nk):
        """The main path's slab launches: rows at the first and last slab
        (zero halo from the tensor map's fill) and inside, written in place."""
        ni, di = 40, 10
        f = torch.from_numpy(_lattice((ni, 9, nk), seed=13)).to(cuda)
        for rows in ((0, di), (ni - di, ni), (di, 2 * di), (0, ni), (ni - 1, ni)):
            self._check_bit_exact(f, False, rows=rows)
            buf = torch.full((ni, 9, nk), float("nan"), device=cuda)
            jacobi_sweep_cuda(f, di=1, dj=1, out=buf[rows[0]:rows[1]], rows=rows)
            want = ref.jacobi_sweep_ref(f)[rows[0]:rows[1]]
            assert torch.equal(buf[rows[0]:rows[1]], want)
            assert bool(buf[:rows[0]].isnan().all()) and bool(buf[rows[1]:].isnan().all())

    @pytest.mark.parametrize("two_step", [False, True])
    @pytest.mark.parametrize("extra", [-1, 0, 1, "2c+1"])
    def test_bit_exact_across_the_i_chunk(self, cuda, two_step, extra):
        """i extents either side of the i chunk the wrappers launch with."""
        chunk = kernel.geometry(two_step)["chunk"]
        ni = 2 * chunk + 1 if extra == "2c+1" else chunk + extra
        f = torch.from_numpy(_lattice((ni, 9, 124), seed=14)).to(cuda)
        self._check_bit_exact(f, two_step)
        if not two_step:
            self._check_bit_exact(f, False, rows=(1, ni - 1))

    @pytest.mark.parametrize("two_step", [False, True])
    def test_every_instance_and_route(self, cuda, two_step):
        """Every compiled (tile, ring depth) instance, through TMA and through
        the 4-byte copies, at small and large i chunks."""
        f = torch.from_numpy(_lattice((37, 21, 244), seed=15)).to(cuda)
        want = (ref.jacobi_two_step_ref if two_step else ref.jacobi_sweep_ref)(f)
        before = (jacobi_sweep_cuda.launches, jacobi_two_step_cuda.launches)
        for v in range(kernel.variants(two_step)):
            for chunk in (5, 16, 37):
                for tma in (True, False):
                    out = torch.full_like(f, float("nan"))
                    kernel.launch(two_step, v, chunk, f, out, tma=tma)
                    torch.cuda.synchronize()
                    assert torch.equal(out, want), (v, chunk, tma)
        assert (jacobi_sweep_cuda.launches, jacobi_two_step_cuda.launches) == before

    def test_unaligned_base_takes_the_copy_route(self, cuda):
        """A lattice whose data starts off 16 bytes cannot use TMA: the same
        kernel's 4-byte-copy instance sweeps it, bit for bit."""
        base = torch.from_numpy(_lattice((6 * 8 * 16 + 1,), seed=16)).to(cuda)
        f = base[1:].view(6, 8, 16)
        assert f.data_ptr() % 16
        self._check_bit_exact(f, False)
        self._check_bit_exact(f, True)

    def test_geometry_and_encode(self, cuda):
        for two_step in (False, True):
            g = kernel.geometry(two_step)
            assert g["tk"] % 4 == 0 and g["blocks_per_sm"] >= 1
            assert g["blocks_per_sm_copy"] >= 1 and g["chunk"] >= 1
        f = torch.zeros((12, 10, 120), device=cuda)
        assert kernel.encode_ns(f, reps=10) > 0

    def test_cuda_tensor_never_takes_plain_path(self, cuda):
        f = torch.zeros((9, 8, 16), device=cuda)
        with pytest.raises(ValueError):
            ops.jacobi_sweep(f, di=4, dj=4)
        with pytest.raises(ValueError):
            jacobi_sweep_cuda(f[:, :, ::2], di=9, dj=8)   # not contiguous
