"""The cross-pod reduce's groups against the reference's tree (CPU).

``train_loop.crosspod_groups(model)`` is what ``make_train_step(
compress_crosspod=True, ...)`` hands ``compressed_psum_tree`` as
``groups=``: each parameter name -> the key path of its leaf in the
reference's tree.  For every arch of the registry at SMOKE width (and
``recurrentgemma-2b`` at 8 layers, where two repeats of its ``("rec",
"rec", "attn")`` pattern share a stage) the groups are held against
``convert.to_reference(model)``: one group per reference leaf, each
group's element count the leaf's size, and its members in the order of
the leaf's ``reps`` axis (stacked, they are the leaf).  The encoder's
blocks, a tied head and the hybrid pattern are checked by name.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.models import init_model
from repro_torch.models.convert import to_reference
from repro_torch.train.train_loop import crosspod_groups

CASES = {arch: (arch, {}) for arch in ARCH_IDS}
CASES["recurrentgemma-2b-8"] = ("recurrentgemma-2b", {"n_layers": 8})


def _model(name: str):
    arch, over = CASES[name]
    return init_model(get_smoke_config(arch).with_(**over), seed=0,
                      device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _members(groups: dict) -> dict:
    out: dict = {}
    for k, g in groups.items():
        out.setdefault(g, []).append(k)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_groups_are_the_reference_leaves(name):
    model = _model(name)
    params = {k: p.detach().to(torch.float32).numpy()
              for k, p in model.named_parameters()}
    groups = crosspod_groups(model)
    assert set(groups) == set(params)
    leaves = dict(_leaves(to_reference(model)))
    members = _members(groups)
    assert set(members) == set(leaves), "one group per reference leaf"
    for g, ks in members.items():
        leaf = leaves[g]
        assert sum(params[k].size for k in ks) == leaf.size, g
        stacked = np.stack([params[k] for k in ks])
        np.testing.assert_array_equal(stacked.reshape(leaf.shape), leaf,
                                      err_msg=f"{g}: members out of order")


def test_groups_of_the_encoder_tied_head_and_hybrid_pattern():
    enc = crosspod_groups(_model("seamless-m4t-large-v2"))
    cfg = get_smoke_config("seamless-m4t-large-v2")
    wq = _members(enc)[("encoder", "stack", "b0_attn", "attn", "wq")]
    assert wq == [f"encoder.blocks.{n}.attn.wq"
                  for n in range(cfg.encoder_layers)]
    assert enc["lm_head"] == ("tok", "lm_head")
    assert _members(enc)[("tok", "lm_head")] == ["lm_head"]

    tied = crosspod_groups(_model("ras-pimc"))
    assert "lm_head" not in tied
    assert _members(tied)[("tok", "embedding")] == ["embedding"]
    assert _members(tied)[("final_norm", "scale")] == ["final_norm"]

    hyb = crosspod_groups(_model("recurrentgemma-2b-8"))
    # stages (("rec", "rec", "attn"), 2) and (("rec", "rec"), 1)
    assert hyb["blocks.0.rec.w_x"] == hyb["blocks.3.rec.w_x"] == (
        "stages", "s0", "b0_rec", "rec", "w_x")
    assert hyb["blocks.1.rec.w_x"] == ("stages", "s0", "b1_rec", "rec",
                                       "w_x")
    assert hyb["blocks.6.rec.w_x"] == ("stages", "s1", "b0_rec", "rec",
                                       "w_x")
    assert _members(hyb)[("stages", "s0", "b2_attn", "attn", "wq")] == [
        "blocks.2.attn.wq", "blocks.5.attn.wq"]
