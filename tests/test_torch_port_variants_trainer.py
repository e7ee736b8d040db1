"""A whole ``Trainer`` run with the train CLI's remaining knobs (deep
projections, logit fusion, remat, final dropout, the fused stacks kept out of
the torch-style draw) against the JAX Trainer's, at dropout 0 from the same
parameters, both optimizers at Adam's eps 1 (``ADAM_EPS``; see
``test_torch_port_variants.py``).

Tolerances as ``test_torch_port_trainer.py``: the records 1e-4 relative plus
1e-6 absolute; the parameters 1e-4 absolute; each parameter tensor's change
over the run against JAX's change within 1% of its largest entry plus 2.5e-7
(``assert_updates_match``).
"""

import jax
import numpy as np
import optax
import pytest

from analysisgnn_tpu.train import loop as jloop
from analysisgnn_tpu_torch.convert import state_dict_from_flax
from analysisgnn_tpu_torch.train import loop as tloop
from analysisgnn_tpu_torch.train.state import ClippedAdamW
from tests.test_torch_port_train import PARAM_ATOL
from tests.test_torch_port_trainer import TRAINER_ATOL, TRAINER_RTOL, _trainer_dm
from tests.test_torch_port_variants import (  # noqa: F401 (the fixture)
    ADAM_EPS,
    assert_updates_match,
    jax_numpy_graph_builder,
)


TRAINER = dict(num_layers=1, hidden_channels=16, out_channels=8, dropout=0.0, main_tasks=("all",), num_epochs=2,
               plain_proj=False, logit_fusion=True, remat=True, final_dropout=True,
               fused_torch_init=False)


def test_trainer_with_the_five_knobs_matches_jax(tmp_path, monkeypatch):
    """A whole Trainer run at dropout 0 against the JAX Trainer's, from the
    same parameters, both optimizers at Adam eps ``ADAM_EPS``."""
    monkeypatch.setattr(jloop, "make_optimizer", lambda schedule, wd: optax.flatten(optax.chain(
        optax.clip_by_global_norm(1.0), optax.adamw(schedule, weight_decay=wd, eps=ADAM_EPS))))
    monkeypatch.setattr(tloop, "make_optimizer", lambda schedule, wd: ClippedAdamW(schedule, eps=ADAM_EPS,
                                                                                   weight_decay=wd))
    jt = jloop.Trainer(jloop.TrainConfig(**TRAINER, checkpoint_dir=str(tmp_path / "j")), _trainer_dm(True))
    jt.save_checkpoint = lambda state, tag: None  # Orbax is slow; the parameters are compared in memory
    init = []
    jinit = jt._init_state

    def capture(example):  # the JAX Trainer's initial parameters, copied before its steps donate them
        state = jinit(example)
        init.append(jax.tree_util.tree_map(np.array, state.params))
        return state

    jt._init_state = capture
    jstate = jt.fit(max_steps_per_epoch=2)
    tt = tloop.Trainer(tloop.TrainConfig(**TRAINER, checkpoint_dir=str(tmp_path / "t"), device="cpu"),
                       _trainer_dm(False))
    assert tt.model.encoder.remat and tt.model.encoder.final_dropout and tt.model.heads.logit_fusion
    # the fused stacks keep their first init under --no_fused_torch_init, which differs between the packages
    # (flax's lecun_normal, the port's seeded normal): the port starts from the JAX Trainer's parameters
    start = state_dict_from_flax(init[0], {"num_layers": 1})
    tstate = tt.fit(max_steps_per_epoch=2, initial_state_dict={k: v.clone() for k, v in start.items()})
    assert tstate.step == int(jstate.step) == 4 and len(tt.history) == len(jt.history) == 2
    for epoch, (trec, jrec) in enumerate(zip(tt.history, jt.history)):
        for k, v in jrec.items():
            if k == "train_loss" or k.startswith("val/"):
                assert trec[k] == pytest.approx(v, rel=TRAINER_RTOL, abs=TRAINER_ATOL), f"epoch {epoch} {k}"
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params), {"num_layers": 1})
    got = tt.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)
    assert_updates_match(start, got, want, "the Trainer's steps")
