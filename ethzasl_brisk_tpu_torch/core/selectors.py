"""The JAX package's backend selectors, taken as checked no-ops.

``BriskFeature`` and ``BriskExtractor`` in the JAX package choose among
TPU formulations whose outputs are equal: the descriptor sampler
(``sampler``, ``patch_h``, ``patch_w``), the candidate top-k (``topk_impl``,
``topk_block_size``, ``topk_block_r``) and eager detection for exact float
tails on XLA:CPU (``eager_exact``). The port has one formulation of each
(kernel K2 for describe, a stable sort for the top-k, torch ops that round
one at a time) and gives their common output, so it takes these knobs to
build from the same keywords (bench.py's config dict) and checks them: a
value the JAX package names is accepted and changes nothing, any other
raises. Where the JAX package's block top-k can certify itself inexact,
the port's sort is exact (``DetectDiagnostics.topk_exact`` is all True).

The AST detector (``BriskFeatureDetector``) takes two more:
``detect_impl`` (``"candidates"``, or ``"dense"``, the JAX package's
whole-map engine, bitwise equal to the candidates engine, which the port
runs for both) and ``raw_cache_model`` (``"emulated"``, ``"exact"``,
``"cache"`` or ``"corner"``, each ported). The JAX facade's asserts hold as
``ValueError``: ``"dense"`` needs ``"emulated"`` and scale suppression.
"""
from __future__ import annotations

SAMPLERS = ("gather", "patch", "patch_ms", "patch_pallas")
TOPK_IMPLS = ("sort", "select", "compact", "block")
DETECT_IMPLS = ("candidates", "dense")
RAW_CACHE_MODELS = ("emulated", "exact", "cache", "corner")
VERSIONS = ("v2", "v1")


def _choice(name: str, value, choices: tuple[str, ...]) -> None:
    if value not in choices:
        raise ValueError(f"{name}={value!r}: the JAX package names {', '.join(choices)}")


def _positive_int(name: str, value) -> None:
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(f"{name}={value!r}: expected a positive int")


def _flag(name: str, value) -> None:
    if not isinstance(value, bool):
        raise ValueError(f"{name}={value!r}: expected a bool")


def check_version(version: str) -> None:
    """The descriptor engine: ``"v2"`` or the legacy ``"v1"``."""
    _choice("version", version, VERSIONS)


def check_extractor_selectors(sampler: str, patch_h: int, patch_w: int) -> None:
    _choice("sampler", sampler, SAMPLERS)
    _positive_int("patch_h", patch_h)
    _positive_int("patch_w", patch_w)


def check_detector_selectors(topk_impl: str, topk_block_size: int, topk_block_r: int,
                             eager_exact: bool) -> None:
    _choice("topk_impl", topk_impl, TOPK_IMPLS)
    _positive_int("topk_block_size", topk_block_size)
    _positive_int("topk_block_r", topk_block_r)
    _flag("eager_exact", eager_exact)


def check_raw_cache_model(raw_cache_model: str) -> None:
    _choice("raw_cache_model", raw_cache_model, RAW_CACHE_MODELS)


def check_ast_selectors(detect_impl: str, raw_cache_model: str,
                        suppress_scale_nonmaxima: bool, eager_exact: bool) -> None:
    _choice("detect_impl", detect_impl, DETECT_IMPLS)
    check_raw_cache_model(raw_cache_model)
    _flag("eager_exact", eager_exact)
    if detect_impl == "dense" and raw_cache_model != "emulated":
        raise ValueError("detect_impl='dense' implements the emulated cache model only")
    if detect_impl == "dense" and not suppress_scale_nonmaxima:
        raise ValueError("detect_impl='dense' implements the suppressed mode only")
