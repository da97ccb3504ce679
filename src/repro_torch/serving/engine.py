"""Serving engine: continuous batching on the locality-aware runtime.

The port of ``repro.serving.engine``.  Requests arrive dynamically and
replicas (model instances) race to serve them, the OpenMP consumer-thread
picture of the paper.  The router is a ``repro_torch.runtime.Executor``
(the port's copy of the reference's runtime) with replicas as locality
domains:

  * each request carries a locality tag = the replica holding its KV/prefix
    cache (requests in a multi-turn session are "first-touched" by the
    replica that prefilled them) — the runtime ``Task.home``;
  * one FIFO queue per replica; a free replica serves its own queue first
    and steals from the longest foreign queue otherwise (balance over
    locality, §2.2) — ``DomainQueues(steal_order="longest")``;
  * a stolen request pays a "page migration": its prefix must be re-prefilled
    on the stealing replica (the nonlocal-access penalty) — the runtime's
    ``steal_penalty`` account.

Routing policies:
  ``locality``     — route to the home replica's queue (homeless requests
                     round-robin); the paper's layer.
  ``round_robin``  — ignore homes on submit; queues + stealing still apply.
  ``single_queue`` — one shared FIFO (a single locality domain): replicas
                     take work in arrival order, locality is accidental.

The engine runs the real model (one prefill and ``max_new`` decode steps
per request) on its device, ``cuda`` unless the caller passes
``device="cpu"``; on the card every attention call of every layer goes
through K3, every WKV recurrence of an RWKV layer through K4 and every
RG-LRU scan of a recurrent layer through K5.  Outputs are identical under every routing policy while the
steal/local statistics differ as the paper predicts.

``trace=`` takes any recorder with ``.attach(executor)`` (such as
``repro.trace.TraceRecorder``) and records the router's behaviour.
``batch=`` drains up to that many queued requests from one queue per grab;
each still runs its own prefill and decode on its own cache.  The
reference's ``control=`` (its control plane) and ``spec=`` (construction
from a declarative spec) paths need ports of ``repro.control`` and
``repro.spec`` and raise ``NotImplementedError`` until then (ROADMAP B6,
B7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.model import Model
from ..runtime import Executor, Task, Worker

POLICIES = ("locality", "round_robin", "single_queue")


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray              # prompt tokens (1D)
    max_new: int
    home_replica: int = -1          # -1: no cached prefix anywhere
    out_tokens: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeStats:
    served: int = 0
    local: int = 0
    stolen: int = 0
    prefill_tokens: int = 0         # includes re-prefills caused by steals

    @property
    def locality_fraction(self) -> float:
        return self.local / max(self.served, 1)


class Replica:
    """One model replica with its own KV-cache arena."""

    def __init__(self, model: Model, params: Any, max_seq: int,
                 batch_size: int = 1):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.batch = batch_size
        # the reference jit-compiles these; the port runs them eagerly
        self._prefill = model.prefill
        self._decode = model.decode_step

    def run(self, req: Request) -> Request:
        model = self.model
        toks = torch.as_tensor(np.asarray(req.tokens), dtype=torch.int64,
                               device=model.device)[None]
        caches = model.init_cache(1, self.max_seq)
        logits, caches = self._prefill(self.params, {"tokens": toks}, caches)
        pos = toks.shape[1]
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for _ in range(req.max_new):
            req.out_tokens.append(int(cur[0, 0]))
            logits, caches = self._decode(self.params, cur, pos, caches)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
            pos += 1
        return req

    def run_batch(self, reqs: list[Request]) -> list[Request]:
        """Serve one coalesced grab of requests on this replica.

        Requests are decoded per-request on their own caches, so the batch
        is token-identical to serving each request alone — the batching win
        lives in the scheduler, not in fused device math yet.
        """
        return [self.run(r) for r in reqs]


class ServingEngine:
    """Replicas as locality domains over a ``runtime.Executor``."""

    def __init__(self, model: Model, params: Any, num_replicas: int = 2,
                 max_seq: int = 128, policy: str = "locality",
                 pool_cap: Optional[int] = 256,
                 trace: Optional[Any] = None,
                 batch: Any = 1,
                 control: Optional[Any] = None,
                 spec: Optional[Any] = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"was asked to run on {self.device}")
        if spec is not None:
            raise NotImplementedError(
                "spec= needs a port of repro.spec (RuntimeSpec, build): "
                "ROADMAP B6")
        if control is not None:
            raise NotImplementedError(
                "control= needs a port of repro.control (ControlLoop): "
                "ROADMAP B7")
        if policy not in POLICIES:
            raise ValueError(policy)
        self.policy = policy
        self.replicas = [Replica(model, params, max_seq)
                         for _ in range(num_replicas)]
        # single_queue = one shared locality domain every replica serves;
        # otherwise one domain per replica (worker wid == replica index).
        num_domains = 1 if policy == "single_queue" else num_replicas
        worker_domains = ([0] * num_replicas if policy == "single_queue"
                          else list(range(num_replicas)))
        # every grab (batched or size 1) goes through the batch handler, so
        # there is exactly one accounting/migration path
        self._exec = Executor(
            num_domains, worker_domains,
            batch=batch,
            batch_handler=self._run_grab,
            steal_order="longest",
            steal_penalty=self._steal_penalty,
            pool_cap=pool_cap,
        )
        self.control = None
        # optional trace hook: record this engine's routing/steal behaviour
        # as a replayable trace (request payloads stay opaque; the
        # submission stream carries home replica + prompt-length cost).
        self.trace = trace
        if trace is not None:
            trace.attach(self._exec)
        self._prefill_base = 0      # first-prefill tokens of served requests
        self._accidental_local = 0  # served by home replica, any routing

    # -- runtime callbacks ---------------------------------------------------
    def _steal_penalty(self, task: Task, worker: Worker) -> float:
        # nonlocal access: a cached prefix must be re-prefilled on the thief
        req: Request = task.payload
        return float(len(req.tokens)) if req.home_replica >= 0 else 0.0

    def _touch(self, req: Request, worker: Worker) -> Request:
        self._prefill_base += len(req.tokens)
        if req.home_replica == worker.wid:
            self._accidental_local += 1
        req.home_replica = worker.wid          # first touch / migration
        return req

    def _run_grab(self, tasks: list[Task], worker: Worker) -> list[Request]:
        reqs = [self._touch(task.payload, worker) for task in tasks]
        return self.replicas[worker.wid].run_batch(reqs)

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        task = self._exec.make_task(payload=req, home=req.home_replica,
                                    cost=float(len(req.tokens)))
        if self.policy == "single_queue":
            domain = 0
        elif self.policy == "round_robin":
            domain = self._exec.next_round_robin()
        else:
            domain = None        # Executor routes: home queue, else round-robin
        self._exec.submit(task, domain=domain)

    def run_until_drained(self) -> list[Request]:
        """Round-robin replica stepping (a discrete stand-in for parallel
        replica workers — ordering, not timing, is what's under test)."""
        return self._exec.run_until_drained()

    @property
    def runtime(self) -> Executor:
        return self._exec

    @property
    def stats(self) -> ServeStats:
        s = self._exec.stats
        # single_queue collapses all replicas onto one domain, so the
        # runtime's domain-based local counter can't see which replica
        # served a request; accidental home hits are counted in the handler
        # instead (there are no steals with a single domain to exclude).
        local = (self._accidental_local if self.policy == "single_queue"
                 else s.local)
        return ServeStats(
            served=s.executed,
            local=local,
            stolen=s.stolen,
            prefill_tokens=self._prefill_base + int(s.steal_penalty),
        )
