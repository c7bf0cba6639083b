"""The one-card cuts of gemma3-12b's and qwen1.5-32b's ``prefill_32k``
and ``train_4k`` (``launch.steps.LM_ONE_CARD``), reckoned on meta tensors
as the dry run reckons a step (``launch.dryrun.reckon``: the cell's
arguments, its outputs and the peak of its temporaries, counted op by op
as the step runs) against the share of an H100 80GB HBM3 that
``chip_smoke.py`` lets a cell's peak take (``PEAK_SHARE``). A train cell
adds what the smoke keeps of its first calls to hold them after the run:
the token table and its gradient, in bf16. No tensor is allocated."""
import importlib.util
import os

import pytest

from repro_torch.configs import registry
from repro_torch.launch import dryrun, steps

# the card's memory as torch reports it (81,079 MiB)
H100_BYTES = 81_079 * 2 ** 20
CELLS = (("gemma3-12b", "prefill_32k"), ("qwen1.5-32b", "prefill_32k"),
         ("gemma3-12b", "train_4k"), ("qwen1.5-32b", "train_4k"))


def _peak_share() -> float:
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PEAK_SHARE


@pytest.mark.parametrize("arch,shape", CELLS)
def test_one_card_cut_reckons_within_the_peak_share(arch, shape):
    cut = steps.LM_ONE_CARD[(arch, shape)]
    _, mem = dryrun.reckon(arch, shape, **cut)
    peak = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            + mem["temp_size_in_bytes"])
    if shape == "train_4k":
        cfg = registry.get_arch(arch).full_config()
        peak += 2 * cfg.vocab_size * cfg.d_model * 2
    assert peak <= _peak_share() * H100_BYTES, (arch, shape, cut, peak)
