"""Port parity: ``utils/roofline.py`` against the JAX package's.

``stage_model`` is static shape math: every row but ``describe``,
``uniformity``, ``match`` and ``pyramid`` equals the JAX row exactly on three
shape sets (bench.py's VGA step at B=16, a B=128 step with the certified
caps, a small single frame). The port's ``describe`` row counts kernel K2's
work, its ``uniformity`` row the reference's paint of each accept, its
``match`` row kernel ``hamming_argmin``'s popcounts and bytes, and its
``pyramid`` row (the JAX model has none) kernel ``pyramid_u8``'s bytes and
operations (the module docstring); each is checked against that count.
``report`` equals JAX's on the same inputs.
``measure_peaks`` runs on the card only (chip_smoke.py ``[utils]``): here
it is checked that it refuses a card it cannot have.
"""
import pytest
import torch

pytest.importorskip("jax")

from ethzasl_brisk_tpu.utils import roofline as jr  # noqa: E402
from ethzasl_brisk_tpu_torch.utils import roofline as tr  # noqa: E402

SHAPES = [
    dict(batch=16, h=480, w=640, n_layers=4, max_candidates=5376, max_keypoints=1024,
         describe_slots=448),
    dict(batch=128, h=480, w=640, n_layers=4, max_candidates=4352, max_keypoints=1024,
         describe_slots=640, pattern_points=66, desc_words=12),
    dict(batch=1, h=120, w=160, n_layers=2, max_candidates=512, max_keypoints=128,
         describe_slots=128, pattern_points=60, desc_words=16),
]


@pytest.mark.parametrize("shape", SHAPES, ids=["vga16", "vga128", "small"])
def test_stage_model_equals_jax_but_describe(shape):
    got, want = tr.stage_model(**shape), jr.stage_model(**shape)
    # The rows modelled on the port's kernels: the match (JAX's is the +-1
    # matmul) and the pyramid (no JAX row).
    on_kernels = ("match", "pyramid")
    assert got.keys() == want.keys() | {"pyramid"}
    for name in want:
        if name not in ("describe", "uniformity", *on_kernels):
            assert got[name] == want[name], name
    b, h, w, kk = shape["batch"], shape["h"], shape["w"], shape["max_keypoints"]
    words = shape.get("desc_words", 12)
    m = got["match"]
    assert m["kind"] == "int"
    assert m["gflops"] == pytest.approx(1e-9 * (b - 1) * kk * kk * words)
    assert m["gbytes"] == pytest.approx(1e-9 * (b * kk * (4 * words + 1) + (b - 1) * kk * 8))
    dims = [(h, w), (2 * (h // 3), 2 * (w // 3))]
    for i in range(2, shape["n_layers"]):
        dims.append((dims[i - 2][0] // 2, dims[i - 2][1] // 2))
    derived = [b * ph * pw for ph, pw in dims[1 : shape["n_layers"]]]
    p = got["pyramid"]
    assert p["kind"] == "bw"
    assert p["gbytes"] == pytest.approx(1e-9 * (b * h * w + sum(derived)))
    assert p["gflops"] == pytest.approx(1e-9 * (15 * derived[0] + 10 * sum(derived[1:])))
    k, problems = shape["max_candidates"], shape["n_layers"] * shape["batch"]
    u = got["uniformity"]
    assert u["kind"] == "bw"
    assert u["gbytes"] == pytest.approx(1e-9 * 14 * k * problems)
    # The reference's work: each accept paints its 31 x 31 patch, four
    # operations a cell, whatever K is.
    assert u["gflops"] == pytest.approx(1e-9 * 4 * 31 * 31 * min(shape["max_keypoints"], k)
                                        * problems)
    p = shape.get("pattern_points", 66)
    slots = shape["describe_slots"] * shape["batch"]
    d = got["describe"]
    assert d["kind"] == "bw"
    assert d["gflops"] == pytest.approx(1e-9 * 149 * p * 2 * slots)
    assert d["gbytes"] == pytest.approx(4e-9 * (3 + p * (22 + 6)) * 2 * slots)
    assert tr._pyramid_pixels(shape["h"], shape["w"], shape["n_layers"]) == \
        jr._pyramid_pixels(shape["h"], shape["w"], shape["n_layers"])


def test_report_equals_jax():
    model = jr.stage_model(**SHAPES[0])
    peaks = dict(peak_gflops=51000.0, peak_gflops_bf16=700000.0, peak_gbs=2900.0)
    stage_ms = dict(scores=0.8, masks=2.5, uniformity=100.0, refine=7.0, match=1.0,
                    describe=3.6, top_k=0.0, unknown=1.0)
    assert tr.report(stage_ms, model, peaks) == jr.report(stage_ms, model, peaks)
    ported = tr.report(stage_ms, tr.stage_model(**SHAPES[0]), peaks)
    assert ported["describe"]["kind"] == "bw" and "top_k" not in ported


def test_measure_peaks_needs_the_card_it_asks_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py measures the peaks")
    with pytest.raises(RuntimeError):
        tr.measure_peaks()


def test_measure_peaks_on_the_cpu_keeps_the_precision():
    """The measurement path on the CPU (perf_counter): JAX's keys, the
    matmul precision reported and left as it was. The numbers are the
    CPU's, not a device's."""
    before = torch.get_float32_matmul_precision()
    peaks = tr.measure_peaks(reps=1, device="cpu")
    assert torch.get_float32_matmul_precision() == before == peaks["f32_matmul_precision"]
    assert peaks["device"] == "cpu"
    for key in ("peak_gflops", "peak_gflops_bf16", "peak_gbs"):
        assert peaks[key] > 0, key
