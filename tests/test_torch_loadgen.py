"""The port's loadgen (deeplearning_cfn_tpu_torch.loadgen) against the JAX
package's, on the CPU.

For each arrival process × request mix × seed, one spec string parsed at
the fleet bench's smoke dimensions gives the same spec, arrival times,
schedule and ``pairs()`` in both packages, and replaying the schedule over
a scripted router (``tests/test_loadgen.py``'s ``_ScriptedRouter``, each
package's ``OverloadError``) gives the same report, submissions and ledger.
Tolerance: none — every value equal, floats included.
"""

import dataclasses

import pytest

from deeplearning_cfn_tpu import loadgen as jax_loadgen
from deeplearning_cfn_tpu.serve.queue import OverloadError as JaxOverload
from deeplearning_cfn_tpu_torch import loadgen as port_loadgen
from deeplearning_cfn_tpu_torch.serve.queue import OverloadError as Overload

PACKAGES = {"jax": (jax_loadgen, JaxOverload),
            "port": (port_loadgen, Overload)}


class _ScriptedRouter:
    """Router lookalike: admits up to ``capacity`` concurrent requests,
    each finishing after ``work`` steps; rejections carry a fixed
    retry-after hint; every submission is stamped with the shared clock."""

    def __init__(self, clock, overload, capacity=1, work=2,
                 retry_after=0.2):
        self.clock = clock
        self.overload = overload
        self.capacity = capacity
        self.work = work
        self.retry_after = retry_after
        self.running = {}
        self.done = set()
        self.ledger = {}
        self.submissions = []

    def submit(self, src_ids, max_new_tokens=None, request_id=None, **kw):
        if len(self.running) >= self.capacity:
            raise self.overload(len(self.running), self.capacity,
                                retry_after_s=self.retry_after)
        self.submissions.append((request_id, self.clock.read(),
                                 list(src_ids), max_new_tokens, kw))
        self.running[request_id] = self.work
        self.ledger[request_id] = {"e2e_s": None}
        return request_id

    def step(self):
        for rid in list(self.running):
            self.running[rid] -= 1
            if self.running[rid] <= 0:
                del self.running[rid]
                self.done.add(rid)
        return len(self.done)

    def pending(self):
        return len(self.running)


def _run(pkg, process, mix, seed):
    loadgen, overload = PACKAGES[pkg]
    spec = loadgen.parse_trace_spec(f"{process}:mix={mix}", src_len=8,
                                    max_new_tokens=4, requests=6)
    gen = loadgen.LoadGenerator(spec, seed=seed, vocab_size=96)
    clock = loadgen.VirtualClock()
    router = _ScriptedRouter(clock, overload)
    report = loadgen.replay(gen, router, clock, tick_s=0.05)
    return {
        "spec": dataclasses.asdict(spec),
        "hot_window": spec.hot_window(),
        "arrival_times": spec.arrival_times(seed),
        "schedule": [dataclasses.asdict(s) for s in gen.schedule],
        "pairs": gen.pairs(),
        "report": dataclasses.asdict(report),
        "submissions": router.submissions,
        "ledger": router.ledger,
        "clock": clock.read(),
    }


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mix", list(jax_loadgen.MIXES))
@pytest.mark.parametrize("process", list(jax_loadgen.PROCESSES))
def test_schedule_and_replay_equal_jax(process, mix, seed):
    assert port_loadgen.PROCESSES == jax_loadgen.PROCESSES
    assert port_loadgen.MIXES == jax_loadgen.MIXES
    ref, got = _run("jax", process, mix, seed), _run("port", process, mix,
                                                     seed)
    assert got["schedule"], "an empty schedule compares nothing"
    for key in ref:
        assert got[key] == ref[key], key
