"""Property-based fuzzing of the two hand-written kernels, on the card.

Random shapes, storage types and value offsets go through the group-pass
kernel and the gather-combine kernel, each held against its plain twin
(the gather kernel bit for bit, under every launch plan) and against a
float64 oracle on the CPU; the public outer product, tensordot and basis
change on the card are held against the CPU port in float64. The checks
themselves are ``symtensor_tpu_torch.testing.kernel_properties``, which
``chip_smoke.py`` runs too. The fixed examples reach every branch of the
group-pass kernel (whole rows, split rows, the sliced tri, unaligned span
ends) and both weight-chunk branches and operand sizes of the gather
kernel; a test checks that they do.

These tests need a CUDA card and skip without one. They import no jax, so
they run with the repository's conftest (which only configures jax) left
out:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_property_cuda.py
"""

import pytest
import torch
from hypothesis import HealthCheck, example, given, settings, strategies as st_

from symtensor_tpu_torch.kernels import gather_mm as gm
from symtensor_tpu_torch.kernels.group_pass import group_eval, group_pass
from symtensor_tpu_torch.testing import kernel_properties as kp

pytestmark = pytest.mark.cuda

f64, f32, bf16, f16 = torch.float64, torch.float32, torch.bfloat16, torch.float16


def fuzz(max_examples):
    """A fixed set of draws on every run, no time limit, no database."""
    return settings(max_examples=max_examples, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


# (rank, dim, storage type, offset): rows wider than a stage and the sliced
# tri at rank 3 and 4 in each type, unaligned spans, and the ranks without
# a group pass
GROUP_PASS_EXAMPLES = [
    (3, 150, f32, 1), (3, 200, bf16, 2), (4, 120, f64, 3), (4, 160, f32, 0),
    (6, 12, bf16, 0), (7, 5, f64, 2), (0, 9, f32, 0), (2, 200, bf16, 1),
]
# (n_a, n_b, R, n_out, type): operands on both sides of 32 KB, R on both
# sides of a weight chunk
GATHER_EXAMPLES = [
    (21, 21, 6, 126, f32), (40_000, 300, 7, 5000, bf16),
    (64, 64, 1500, 300, f64), (9000, 9000, 2100, 1001, f16),
]


@st_.composite
def group_pass_cases(draw):
    rank = draw(st_.integers(0, 7))
    dim = draw(st_.integers(1, kp.max_dim(rank)))
    return rank, dim, draw(st_.sampled_from([f32, bf16, f64])), draw(st_.integers(0, 3))


@given(case=group_pass_cases(), seed=st_.integers(0, 2**31 - 1))
@example(case=GROUP_PASS_EXAMPLES[0], seed=0)
@example(case=GROUP_PASS_EXAMPLES[1], seed=1)
@example(case=GROUP_PASS_EXAMPLES[2], seed=2)
@example(case=GROUP_PASS_EXAMPLES[3], seed=3)
@example(case=GROUP_PASS_EXAMPLES[4], seed=4)
@example(case=GROUP_PASS_EXAMPLES[5], seed=5)
@example(case=GROUP_PASS_EXAMPLES[6], seed=6)
@example(case=GROUP_PASS_EXAMPLES[7], seed=7)
@fuzz(40)
def test_group_pass_and_public_op_property(cuda, case, seed):
    rank, dim, dtype, offset = case
    before, before_eval = group_pass.launches, group_eval.launches
    kp.check_group_pass(rank, dim, dtype, offset, seed, cuda)
    if rank >= 3:  # two direct launches of each mode and the public op's
        assert group_pass.launches == before + 2
        assert group_eval.launches == before_eval + 3


@st_.composite
def gather_cases(draw):
    dtype = draw(st_.sampled_from([f32, bf16, f64, f16]))
    per = kp.GATHER_OPERAND_BYTES // dtype.itemsize
    n_a, n_b = (draw(st_.integers(1, 2 * per)) for _ in "ab")
    R = draw(st_.integers(1, 2 * kp.GATHER_W_CHUNK + 200))
    return n_a, n_b, R, draw(st_.integers(1, max(1, 2**21 // R))), dtype


@given(case=gather_cases(), seed=st_.integers(0, 2**31 - 1))
@example(case=GATHER_EXAMPLES[0], seed=0)
@example(case=GATHER_EXAMPLES[1], seed=1)
@example(case=GATHER_EXAMPLES[2], seed=2)
@example(case=GATHER_EXAMPLES[3], seed=3)
@fuzz(30)
def test_gather_combine_property(cuda, case, seed):
    before = gm.gather_combine.launches
    kp.check_gather(*case, seed, cuda)
    assert gm.gather_combine.launches == before + len(gm.TILE_CHOICES)


@given(ra=st_.integers(1, 3), rb=st_.integers(1, 3), dim=st_.integers(2, 12),
       d_out=st_.integers(1, 12), seed=st_.integers(0, 2**31 - 1))
@example(ra=3, rb=3, dim=12, d_out=5, seed=0)
@fuzz(20)
def test_public_ops_on_card_match_cpu_float64(cuda, ra, rb, dim, d_out, seed):
    kp.check_public_ops(ra, rb, dim, d_out, seed, cuda)


def test_examples_reach_every_branch(cuda):
    """The fixed examples above cover every branch, read from the launch
    tables of the very tensors the checks launch on."""
    gp = [kp.check_group_pass(*c, seed=i, device=cuda)
          for i, c in enumerate(GROUP_PASS_EXAMPLES)]
    counts = kp.summary_counts(gp, kp.GROUP_PASS_BRANCHES)
    assert all(counts.values()), counts
    ga = [kp.check_gather(*c, seed=i, device=cuda) for i, c in enumerate(GATHER_EXAMPLES)]
    counts = kp.summary_counts(ga, kp.GATHER_BRANCHES)
    assert all(counts.values()), counts
