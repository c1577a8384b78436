"""The MoE LM configs' dry-run cells (qwen3-moe-30b-a3b,
llama4-maverick-400b-a17b) held against the JAX package's on both
production meshes (``_torch_dryrun.check_cell_on_both_meshes``): their
train and prefill steps cut the tokens into the mesh's 16 or 32 batch
shards, so each mesh has its own trace. Specs, abstract states and the
tiny cells run concretely are in ``test_torch_dryrun_lm.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_dryrun import check_cell_on_both_meshes  # noqa: E402
from repro.configs import lm_family as jlm  # noqa: E402

MOE_ARCHS = ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("shape", list(jlm.LM_SHAPES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cells_hold_the_reference_layout(arch, shape):
    records = check_cell_on_both_meshes(arch, shape)
    one = [r["one_device"] for r in records.values()]
    if shape in ("train_4k", "prefill_32k"):
        # 16 and 32 token groups: two traces of the same arguments
        assert one[0]["argument_bytes"] == one[1]["argument_bytes"]
    else:
        assert one[0] == one[1]

