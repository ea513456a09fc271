"""gslm_tpu_torch's parity matrix (utils/paritycheck.py) against
gslm_tpu's, on the CPU, where both of its sides take the plain versions.

The variants are JAX's but ``grads_sortseg`` and ``grads_pack8`` (read
from JAX's source: running JAX's matrix needs its compiled kernels), with
JAX's tolerances. The quick matrix with both sides on the CPU is ok with
zero error (the CPU side runs deterministic algorithms); a perturbation
of one output of the reference side just beyond a variant's tolerance
turns that variant, and only it, ``ok: False``. The card runs the matrix
at full size (chip_smoke.py) and quick (tests/test_torch_cuda.py)."""

import copy
import inspect
import re

import numpy as np
import pytest
import torch

from gslm_tpu.utils import paritycheck as j_pc
from gslm_tpu_torch.utils import paritycheck as pc
from torch_threads import one_thread  # noqa: F401 (autouse)


def test_variants_are_jax_minus_the_tpu_ones():
    names = re.findall(r'record(?:_grads)?\(\s*"(\w+)"',
                       inspect.getsource(j_pc.run_parity_matrix))
    assert len(names) == 12
    assert list(pc.VARIANTS) == [n for n in names if n not in (
        "grads_sortseg", "grads_pack8")]
    assert (pc.GRAD_RTOL, pc.IMG_ATOL) == (j_pc.GRAD_RTOL, j_pc.IMG_ATOL)
    assert pc.GROUPS == j_pc.GROUPS
    doc = pc.__doc__
    assert "grads_sortseg" in doc and "grads_pack8" in doc


@pytest.fixture(scope="module")
def quick():
    inp = pc._inputs(True)
    return inp, pc._outputs_on(inp, "cpu")


def test_quick_matrix_on_the_cpu_is_ok_with_zero_error(quick):
    res = pc._run("cpu", "cpu", quick=True)
    assert res["ok"]
    assert list(res["variants"]) == list(pc.VARIANTS)
    for name, v in res["variants"].items():
        assert v["ok"] and v["max_err"] == 0.0, name
        if name.startswith("grads"):
            assert set(v["per_group"]) == set(pc.GROUPS)
    # the same outputs as the module's fixture: the CPU side is repeatable
    again = pc._compare(quick[1], pc._outputs_on(quick[0], "cpu"))
    assert all(v["max_err"] == 0.0 for v in again["variants"].values())


def test_inputs_are_jax_matrix_seeds(quick):
    from gslm_tpu.utils.synthetic import random_gaussians
    inp = quick[0]
    jp, jaux = random_gaussians(np.random.default_rng(7), n=512,
                                capacity=512, num_images=4)
    for g in pc.GROUPS:
        np.testing.assert_array_equal(inp["groups"][g],
                                      np.asarray(getattr(jp, g)), err_msg=g)
    np.testing.assert_array_equal(inp["alive"], np.asarray(jaux.alive))
    assert (inp["H"], inp["W"], inp["H4"], inp["dup"]) == (96, 128, 128,
                                                           1 << 13)
    grads = quick[1]["grads"]
    assert all(np.abs(grads[g]).max() > 0 for g in pc.GROUPS)


# output of the reference side → the variant that reads it
READS = {"image": "fwd_image", "grads": "grads_scatter",
         "grads_nocull": "grads_nocull", "image_bucket2": "fwd_bucket2",
         "grads_bucket2": "grads_bucket2", "image_bucket4": "fwd_bucket4",
         "grads_bucket4": "grads_bucket4", "grads_batch2": "grads_batch2",
         "jvp_image": "jvp_image", "jvp_residual": "jvp_lm_operator"}


@pytest.mark.parametrize("key", list(READS))
def test_perturbed_reference_fails_its_variant(quick, key):
    got = quick[1]
    ref = copy.deepcopy(got)
    out = ref[key]
    if isinstance(out, dict):        # gradients: 1.5e-4 of one group's max
        a = out["opacity"]
        a.flat[np.argmax(np.abs(a))] *= 1 - 1.5e-4
    elif key.startswith("image"):    # images: 2e-5 at one pixel
        out.flat[out.size // 2] += 2e-5
    elif key == "jvp_image":         # past atol 1e-4 + rtol 1e-4 at one
        i = np.argmax(np.abs(out))
        out.flat[i] += 2e-4 + 2e-4 * abs(out.flat[i])
    else:                            # residual tangent: 2e-4 of the max
        out.flat[np.argmax(np.abs(out))] *= 1 + 2e-4
    res = pc._compare(got, ref)
    failed = [n for n, v in res["variants"].items() if not v["ok"]]
    assert failed == [READS[key]] and not res["ok"]


def test_run_parity_matrix_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pc.run_parity_matrix(quick=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pc.main(["--quick"])
