"""A run with its timed path broken underneath comes out not correct: once
for each fault the cells can have. The run is a rehearsal (it skips the look
for a card) driven in this process, with the program patched."""

import numpy as np
import pytest

from conftest import CELLS, run_inline


def unchanged(make_step):
    """A step factory whose step returns its state unchanged (the iteration
    count aside, so the loop still ends)."""

    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def still(state, consts):
            moved, stats = step(state, consts)
            return state._replace(iteration=moved.iteration), stats

        return still

    return make


@pytest.mark.parametrize("workload", CELLS)
def test_holobench_sound_run_is_correct(workload):
    assert run_inline(workload)[0]["correct"] is True


@pytest.mark.parametrize("workload", CELLS)
def test_holobench_step_left_unchanged_is_caught(monkeypatch, workload):
    from slmsuite_torch.ops import compressed

    monkeypatch.setattr(compressed, "make_compressed_carry_step",
                        unchanged(compressed.make_compressed_carry_step))
    assert run_inline(workload)[0]["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_holobench_altered_answer_is_caught(monkeypatch, workload):
    from slmsuite_torch.holography.algorithms import Hologram

    get_phase = Hologram.get_phase

    def altered(self, *args, **kwargs):
        phase = np.array(get_phase(self, *args, **kwargs))
        phase[: max(1, phase.shape[0] // 16)] += 0.5
        return phase

    monkeypatch.setattr(Hologram, "get_phase", altered)
    assert run_inline(workload)[0]["correct"] is False
