"""Serving traffic: whole scores through ``inference/predict.py::predict_score_ids``
(the call ``cli/predict.py`` makes), offered at a fixed rate.

Set-up makes a pool of ``pool`` synthetic scores from the seed (their
lengths a fixed set, log-uniform over ``notes_min``-``notes_max``, the same
for every seed), makes the parameters on the card from the seed, and serves
every score of the pool once, which builds the kernels and warms every
capacity rung the window uses.  The window is an open loop: request ``i``
(the pool in a seeded order, over and over) is due ``i / rate_per_s``
seconds after the window opens, and one server takes the requests in turn.
It takes no request after ``--seconds`` (none due later, and none not yet
started); the window closes when the last one taken is back.
``serve_notes_per_s`` is the notes of every request completed in the window
over the window's seconds.  The rate lies far above what one server
sustains, so the queue grows from the first request on and the server
never waits: the rate completed is the server's own.  Each run counts the
times the server found no request due (``server_waits``, held to 0: where
it waits, the schedule and not the server sets the rate, and the rate must
rise) and how far the server lags the schedule when the window closes
(``lag_s``, printed).  A request's service time runs from the call to its
ids on the host; the traced run serves ``traced_requests`` on the same
schedule and reads their service times' 95th percentile.

The served ids of the scores in a sample drawn from the seed (the longest
score of the pool and ``checked_scores - 1`` others) are kept, every time
they are served, and after the window the reference judges each of them.
"""

from __future__ import annotations

import sys
import time
import traceback
from typing import Dict, List, Mapping

import numpy as np
import torch

from gpubench.gen.scores import log_spaced_lengths, synthetic_score
from gpubench.harness import trace
from gpubench.reference import decode as ref_decode
from gpubench.reference import features as ref_features
from gpubench.reference import graph as ref_graph
from gpubench.reference import model as ref_model


def _seeds(seed: int) -> Dict[str, int]:
    a, b = np.random.SeedSequence(seed).generate_state(2, dtype=np.uint64)
    return {"data": int(a), "weights": int(b)}


class ServeRun:
    def __init__(self, cell, seed: int, device):
        from analysisgnn_tpu_torch.models.analysis import model_from_config

        self.cfg, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.seeds = _seeds(seed)
        tr = self.traffic
        rng = np.random.default_rng(self.seeds["data"])
        lengths = log_spaced_lengths(tr["pool"], tr["notes_min"], tr["notes_max"])
        self.pool = [synthetic_score(int(n), rng) for n in lengths]
        self.order = rng.permutation(len(self.pool))
        longest = int(np.argmax(lengths))
        others = rng.permutation([i for i in range(len(self.pool)) if i != longest])
        self.sample = {longest, *map(int, others[: tr["checked_scores"] - 1])}
        self.kept: Dict[int, List[Dict[str, np.ndarray]]] = {i: [] for i in self.sample}
        gen = torch.Generator(device=self.device).manual_seed(self.seeds["weights"])
        self.model = model_from_config(self.cfg, device=self.device)
        self.model.load_state_dict(ref_model.make_parameters(self.cfg, gen, self.device), strict=True)
        self.model.eval()
        self.next_request = 0
        self.load: Dict[str, float] = {}
        for i in range(len(self.pool)):
            self._serve(i)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _serve(self, item: int) -> Dict[str, np.ndarray]:
        from analysisgnn_tpu_torch.inference.predict import predict_score_ids

        return predict_score_ids(self.model, self.pool[item], feature_type="voice", add_beats=False,
                                 add_measures=False, bucket_factor=self.traffic["bucket_factor"], device=self.device)

    def _run(self, seconds: float = None, count: int = None) -> Dict:
        """Requests on the schedule, until ``seconds`` have passed (none
        taken after), or ``count`` of them; returns every service time, the
        notes served, the failures, the server's waits, its lag behind the
        schedule at the close and the window's seconds."""
        period = 1.0 / self.traffic["rate_per_s"]
        latencies, notes, failed, waits = [], 0, 0, 0
        self._sync()
        t0 = time.perf_counter()
        i = 0
        while (count is not None and i < count) or (
                seconds is not None and i * period < seconds and time.perf_counter() - t0 < seconds):
            wait = t0 + i * period - time.perf_counter()
            if wait > 0:
                waits += 1
                time.sleep(wait)
            item = int(self.order[self.next_request % len(self.order)])
            try:
                start = time.perf_counter()
                with torch.profiler.record_function("bench.request"):
                    ids = self._serve(item)
                latencies.append(time.perf_counter() - start)
                notes += len(self.pool[item])
                if item in self.kept:
                    self.kept[item].append(ids)
            except Exception:  # a failed request is counted and the window goes on
                traceback.print_exc(file=sys.stderr)
                latencies.append(float("inf"))
                failed += 1
            self.next_request += 1
            i += 1
        elapsed = time.perf_counter() - t0
        self.load = {"server_waits": waits, "lag_s": elapsed - i * period}
        return {"latencies": latencies, "notes": notes, "failed": failed, "seconds": elapsed}

    def window(self, seconds: float) -> Dict:
        r = self._run(seconds=seconds)
        return {"attempted": len(r["latencies"]), "failed": r["failed"],
                "metrics": {"serve_notes_per_s": r["notes"] / r["seconds"]}}

    def traced(self, kind: str) -> Dict:
        out = {}
        with trace.traced(out):
            r = self._run(count=self.traffic["traced_requests"])
        out.update(attempted=len(r["latencies"]), failed=r["failed"], steps=len(r["latencies"]), work={},
                   service_p95_ms=1e3 * float(np.percentile(r["latencies"], 95)))
        return out

    def describe(self) -> List[str]:
        lengths = sorted(len(na) for na in self.pool)
        return [f"pool: {len(self.pool)} scores of {lengths[0]}-{lengths[-1]} notes, "
                f"{self.traffic['rate_per_s']} requests/s offered, checked scores {sorted(self.sample)}"]

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ the reference

    def reference_scores(self, item: int, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        na = self.pool[item]
        dev = self.device
        edges = {r: torch.from_numpy(e).to(dev) for r, e in ref_graph.note_edges(na).items()}
        with torch.no_grad():
            x = ref_model.encode(params, self.cfg, torch.from_numpy(ref_features.voice_features(na)).to(dev),
                                 torch.from_numpy(ref_features.pitch_spelling(na)).to(dev),
                                 torch.from_numpy(ref_features.key_signature(na)).to(dev), edges, len(na))
            logits = ref_model.classify(params, self.cfg, x)
        return ref_decode.scores(logits, edges["onset"], np.asarray(na["onset_div"]))

    def reference_params(self) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device).manual_seed(self.seeds["weights"])
        return ref_model.make_parameters(self.cfg, gen, self.device)

    def check(self) -> Dict[str, float]:
        params = self.reference_params()
        out = {"logit_gap": 0.0, "prob_gap": 0.0, "served_checked": 0, **self.load}
        with ref_model.precision(False):
            for item, served in self.kept.items():
                ref = self.reference_scores(item, params) if served else None
                for ids in served:
                    for k, v in ref_decode.gaps(ref, ids).items():
                        out[k] = max(out[k], v)
                    out["served_checked"] += 1
        if not out["served_checked"]:  # nothing judged is nothing shown correct
            out["logit_gap"] = out["prob_gap"] = float("inf")
        return out


def setup(cell, seed: int, device="cuda") -> ServeRun:
    return ServeRun(cell, seed, device)
