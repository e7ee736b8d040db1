"""``correct`` comes out false when the timed path is broken underneath: a
run driven on the CPU at a tiny size past the harness's look for a card,
with a fault planted in the port, judged against the cell's committed
limits; and the control (the reference in TF32 in the program's place)
fails them on the card."""

import pytest
import torch

from conftest import tiny_cell
from gpubench.harness import checks
from gpubench.harness.manifest import load_driver

TRAIN_CELLS = ["hybridgnn.train.cli", "hybridhgt.train.cli"]


def _judge(cell, seed=2**32 + 3):
    run = load_driver(cell.traffic).setup(cell, seed, "cpu")
    run.window(0.05)
    run.release()
    return checks.judge(run.check(), cell.limits)


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(name, monkeypatch, cpu_threads):
    from analysisgnn_tpu_torch.train import state

    monkeypatch.setattr(state.ClippedAdamW, "update", lambda self, *a, **k: None)
    correct, table = _judge(tiny_cell(name))
    assert not correct, table


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_half_of_the_batch_left_out_is_not_correct(name, monkeypatch, cpu_threads):
    from analysisgnn_tpu_torch.train import step

    original = step._task_weights

    def half(batch, cfg):
        base, weights = original(batch, cfg)
        keep = torch.arange(base.shape[0], device=base.device) % 2 == 0
        return base & keep, {k: w & keep for k, w in weights.items()}

    monkeypatch.setattr(step, "_task_weights", half)
    correct, table = _judge(tiny_cell(name))
    assert not correct, table


def test_an_altered_served_id_is_not_correct(monkeypatch, cpu_threads):
    from analysisgnn_tpu_torch.inference import predict

    original = predict.predict_score_ids

    def altered(*args, **kwargs):
        out = original(*args, **kwargs)
        out["localkey"] = out["localkey"].copy()
        out["localkey"][0] = (out["localkey"][0] + 1) % 50
        return out

    monkeypatch.setattr(predict, "predict_score_ids", altered)
    correct, table = _judge(tiny_cell("hybridgnn.serve.scores"))
    assert not correct, table


def test_a_server_that_waits_for_its_schedule_is_not_correct(cpu_threads):
    """Offered below what the server sustains, the rate is the schedule's,
    not the server's: the run is refused."""
    cell = tiny_cell("hybridgnn.serve.scores")
    cell.traffic["rate_per_s"] = 5.0
    run = load_driver(cell.traffic).setup(cell, 2**32 + 4, "cpu")
    run.window(0.5)
    run.release()
    readings = run.check()
    correct, table = checks.judge(readings, cell.limits)
    assert readings["server_waits"] > 0 and not correct, table


@pytest.mark.chip
@pytest.mark.parametrize("name", TRAIN_CELLS + ["hybridgnn.serve.scores"])
def test_the_tf32_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card; this test runs on the chip")
    cell = tiny_cell(name, hidden=256, out=128)
    if cell.traffic["driver"] == "train":  # the cell's own batch, from a smaller corpus
        cell.traffic.update(scores=12, notes_min=1000, notes_max=3000, batch_size=3, subgraph_size=500)
    else:
        cell.traffic.update(pool=6, notes_min=1000, notes_max=8000)
    run = load_driver(cell.traffic).setup(cell, 2**31 + 5, torch.device("cuda", 0))
    run.release()
    if cell.traffic["driver"] == "train":
        readings = checks.train_readings(run.reference(tf32=True), run.reference())
    else:
        from gpubench.reference import decode, model

        params = run.reference_params()
        readings = {"logit_gap": 0.0, "prob_gap": 0.0}
        for item in range(len(run.pool)):
            with model.precision(False):
                ref = run.reference_scores(item, params)
            with model.precision(True):
                ctl = run.reference_scores(item, params)
            for k, v in decode.gaps(ref, {t: s.argmax(-1).numpy() for t, s in ctl.items()}).items():
                readings[k] = max(readings[k], v)
    correct, table = checks.judge(readings, cell.limits)
    assert not correct, table
