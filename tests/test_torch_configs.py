"""The port's config registry (``repro_torch.configs``) against the JAX
package's: every registered architecture and its ``smoke()`` variants
field for field, the shape cells, the TSQR workloads, and the reference's
``test_exact_published_configs`` on the port."""
import dataclasses

import pytest

pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
from repro.configs import base as jbase  # noqa: E402
from repro.configs import tsqr_paper as jtsqr  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import base, tsqr_paper  # noqa: E402

ARCHS = jbase.list_archs()
# overrides a test or a launcher passes to smoke(): depth, a window, a
# chunk, the dtype and a MoE fan-out
OVERRIDES = [
    {},
    {"n_layers": 1, "n_experts": 2, "top_k": 1, "sliding_window": 8},
    {"q_chunk": 8, "pad_heads_to": 8, "remat": True},
    {"dtype": "bfloat16", "capacity_factor": 1.0, "moe_decode_groups": 2},
]


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_registry_lists_the_reference_archs():
    assert configs.list_archs() == ARCHS
    assert len(ARCHS) == 10


def test_model_config_fields_and_defaults_match():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jbase.ModelConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(base.ModelConfig)]
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_published_config_matches_reference(arch):
    got, want = configs.get_config(arch), jbase.get_config(arch)
    assert _fields(got) == _fields(want)
    assert (got.d_head, got.d_inner, got.n_ssm_heads) == (
        want.d_head, want.d_inner, want.n_ssm_heads)
    assert [s.name for s in configs.shapes_for(got)] == [s.name for s in jbase.shapes_for(want)]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: ",".join(o) or "none")
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_matches_reference(arch, overrides):
    got = configs.get_config(arch).smoke(**overrides)
    want = jbase.get_config(arch).smoke(**overrides)
    assert _fields(got) == _fields(want)
    assert (got.d_head, got.d_inner, got.n_ssm_heads) == (
        want.d_head, want.d_inner, want.n_ssm_heads)


def test_shape_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


def test_tsqr_workloads_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tsqr_paper.WORKLOADS.items()} == {
        k: dataclasses.asdict(v) for k, v in jtsqr.WORKLOADS.items()}


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("not-an-arch")


def test_configs_are_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        configs.get_config("olmo-1b").n_layers = 1


def test_exact_published_configs():
    """The reference's ``tests/test_models_smoke.py::test_exact_published_configs``
    on the port's registry."""
    get_config = configs.get_config
    c = get_config("qwen2-moe-a2.7b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads) == (24, 2048, 16, 16)
    assert (c.n_experts, c.top_k, c.d_expert_ff, c.vocab) == (60, 4, 1408, 151936)
    c = get_config("mixtral-8x22b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff) == (
        56, 6144, 48, 8, 16384)
    assert (c.n_experts, c.top_k, c.vocab, c.sliding_window) == (8, 2, 32768, 4096)
    c = get_config("gemma2-9b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == (
        42, 3584, 16, 8, 14336, 256000)
    assert c.local_global and c.attn_logit_softcap == 50.0
    c = get_config("olmo-1b")
    assert (c.n_layers, c.d_model, c.d_ff, c.vocab, c.norm) == (
        16, 2048, 8192, 50304, "ln_nonparam")
    c = get_config("qwen3-0.6b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff) == (
        28, 1024, 16, 8, 3072)
    assert c.qk_norm
    c = get_config("minitron-4b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == (
        32, 3072, 24, 8, 9216, 256000)
    c = get_config("whisper-medium")
    assert (c.n_layers, c.n_enc_layers, c.d_model, c.d_ff, c.vocab) == (
        24, 24, 1024, 4096, 51865)
    c = get_config("mamba2-2.7b")
    assert (c.n_layers, c.d_model, c.vocab, c.ssm_state) == (64, 2560, 50280, 128)
    assert c.d_inner == 5120 and c.n_ssm_heads == 80
    c = get_config("zamba2-7b")
    assert (c.n_layers, c.d_model, c.n_heads, c.vocab, c.ssm_state) == (
        81, 3584, 32, 32000, 64)
    c = get_config("qwen2-vl-72b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == (
        80, 8192, 64, 8, 29568, 152064)
    assert c.mrope_sections == (16, 24, 24)
