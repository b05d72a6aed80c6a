"""The port's configuration and sizing agree with the JAX package's, and the
port imports neither JAX nor the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from apertis_llm_tpu.config import ApertisConfig as JaxConfig
from apertis_llm_tpu.models.factory import calculate_model_dimensions as jax_dims
from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.factory import calculate_model_dimensions

torch.set_num_threads(2)
REPO_ROOT = Path(__file__).resolve().parent.parent

ARG_SETS = {
    "ssm": dict(attention_type="selective_linear", hidden_size=256,
                num_attention_heads=4, ssm_d_state=16, ssm_d_inner=999),
    "mha": dict(hidden_size=384, num_attention_heads=6, use_rmsnorm=True,
                use_swiglu=True, attention_probs_dropout_prob=0.0),
    "moe": dict(use_expert_system=True, num_experts=4, experts_per_token=9,
                ssm_dt_rank=7),
    "multimodal": dict(multimodal=True, image_size=64, vision_patch_size=8,
                       vision_embed_dim=96, dtype="bfloat16", mesh_axes={"data": 2}),
}


@pytest.mark.parametrize("name", sorted(ARG_SETS))
def test_config_to_dict_matches_jax(name):
    kwargs = ARG_SETS[name]
    ours = ApertisConfig(**kwargs)
    assert ours.to_dict() == JaxConfig(**kwargs).to_dict()
    assert ApertisConfig.from_dict(ours.to_dict()) == ours
    assert (ours.head_dim, ours.swiglu_ffn_dim, ours.num_image_tokens, ours.qkv_bias) == (
        lambda j: (j.head_dim, j.swiglu_ffn_dim, j.num_image_tokens, j.qkv_bias))(
            JaxConfig(**kwargs))


@pytest.mark.parametrize("target", ["125M", "1.5B", "6.7B"])
def test_model_dimensions_match_jax(target):
    assert calculate_model_dimensions(target, 32000) == jax_dims(target, 32000)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import apertis_llm_torch, apertis_llm_torch.inference.engine\n"
            "import apertis_llm_torch.models.convert, apertis_llm_torch.models.factory\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'apertis_llm_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO_ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
