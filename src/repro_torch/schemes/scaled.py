"""Scaled-architecture schemes — the port of `repro/schemes/scaled.py`:
every scaled family's (dense, MoE, VLM, SSM, hybrid, audio) CL / FL /
SL behind the same `Scheme` protocol and `Experiment` runner as the
paper's tiny model. A VLM batch carries stub `patch_embeds` and an audio
batch stub `frames`, drawn from the experiment's rng after each batch's
rows (eval: from `default_rng(999)`), as in the JAX package.

* `ScaledCentralizedScheme` — the synthetic corpus crosses the radio
  once at `init` (`Radio.send_tokens`: bit errors corrupt token ids; a
  perfect link is noiseless but still billed), then `make_train_step`
  runs radio-silent server steps, `steps_per_cycle` a cycle.
* `ScaledSplitScheme` — `make_train_step` with an SL `WirelessConfig`:
  the split forward and `channel_crossing` run inside each step (K1 for
  each leg of each microbatch on the card); the legs are billed at the
  DRAWN ARQ counts, replayed from the same keys.
* `ScaledFederatedScheme` — one `round` is `make_fl_train_step`'s whole
  cycle (J local SGD-momentum steps per user + the quantized stacked
  sync: K1, or K2 under `use_kernel`); the sync is billed by replaying
  its fade/ARQ draw on the same `key.fold_in(999)`, per user
  (`bits_normalizer = n_users`).

RNG contract (the JAX package's, through the `Key` seam): CL/SL rounds
fold per-step keys from the cumulative step counter off `key(seed)`; FL
rounds use `key(seed + 3).fold_in(cycle)`; the CL upload draws on
`key(seed + 7)`; eval slice i on `key(999 + i)`. Data is drawn from the
experiment's numpy rng (`seed + 1`) by sampling with replacement.
Weights come from a torch generator seeded with `seed` (not JAX's draw).

FLOPs: the JAX package asks XLA for the cost of the compiled round
program; here one microbatch's step is run on meta tensors under
`torch.utils.flop_counter.FlopCounterMode` (its matmuls, in the forward,
the backward and any remat recompute) and multiplied by the step's
microbatches (each has the same shapes), with the JAX package's user /
server apportioning. An xLSTM's matmuls are all per token or per
predicted token (no attention), so its count is affine in the sequence:
it is taken at one and at two tokens and extended to seq_len, which
spares the meta step's Python loop over time. The count equals the
matmul FLOPs that the JAX package's dry run reads from the compiled HLO
(launch/hlo_analysis.py's `dot_flops`); XLA's `cost_analysis`, which the
JAX package's `RoundReport` reports, counts a scan's body once.

`lower_step(mesh)` readies the round's step for a mesh without running
it (runtime/train_step.py's `Lowered`: meta state and batch, their
resolved specs, the FLOP count, the bytes per device) for
launch/dryrun.py; `warmup_compile()` builds and loads the kernel
libraries the rounds launch (the `--aot-warmup` flag).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, WirelessConfig
from repro_torch.core import federated as FED
from repro_torch.core import split as SPLIT
from repro_torch.core import wire as W
from repro_torch.core.draws import Key
from repro_torch.data.pipeline import synthetic_corpus
from repro_torch.models import api as M
from repro_torch.models.encdec import src_len
from repro_torch.nn import resolve_device, tree_leaves, tree_map
from repro_torch.runtime.fl_runtime import SYNC_KEY_FOLD, make_fl_train_step
from repro_torch.runtime.train_step import (Lowered, _forward,
                                            LIVE_DATA_SHARDS,
                                            auto_microbatch, init_train_state,
                                            key_sds, make_local_step,
                                            make_train_step, metrics_sds,
                                            train_state_axes, train_state_sds,
                                            window_for)
from repro_torch.schemes.base import RoundReport, SchemeState, train_cycle
from repro_torch.schemes.radio import Radio

DEFAULT_SHAPE = ShapeConfig("scaled", 128, 8, "train", microbatch=8)
UPLOAD_STREAM = 7     # the CL corpus upload draws on key(seed + 7)
FL_STREAM = 3         # FL cycle k draws on key(seed + 3).fold_in(k)
EVAL_KEY = 999        # eval slice i is scored on key(999 + i)
DEFAULT_LR = 3e-4
SCALED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


class _ScaledScheme:
    """Shared plumbing: the synthetic-corpus contract, with-replacement
    batch sampling off the experiment rng, next-token-accuracy eval."""
    epochs_per_cycle = 1
    bits_normalizer = 1.0

    def __init__(self, cfg, shape: Optional[ShapeConfig] = None,
                 wcfg=None, capture: bool = False,
                 optimizer: str = "adamw", steps_per_cycle: int = 4,
                 device="cuda", key=Key):
        if capture:
            raise ValueError("capture=True is a tiny-scheme privacy-eval "
                             "feature; the scaled schemes do not observe")
        if cfg.family == "tiny":
            raise ValueError("the paper model runs the tiny schemes; "
                             "build_scheme routes it there")
        if cfg.family not in SCALED_FAMILIES:
            raise ValueError(
                f"unknown family {cfg.family!r}; the scaled schemes train "
                f"{list(SCALED_FAMILIES)}")
        self.cfg = cfg
        self.shape = shape or DEFAULT_SHAPE
        self.wcfg = wcfg
        self.optimizer = optimizer
        self.steps_per_cycle = int(steps_per_cycle)
        self.device = resolve_device(device)
        self.key = key              # seed -> root Key (the draw seam)
        self.radio = Radio.from_wcfg(wcfg)
        self.captures: dict = {}
        self._cost_flops: Optional[float] = None

    # ------------------------------------------------------------- data
    def default_data(self, n_train: int, n_test: int, seed: int):
        """The corpus `Experiment` feeds this scheme when none is given:
        synthetic Zipf LM rows (labels = tokens)."""
        x, y = synthetic_corpus(self.cfg, n_train + n_test,
                                self.shape.seq_len, seed)
        return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])

    def _check_corpus(self, xtr) -> np.ndarray:
        xtr = np.asarray(xtr)
        if xtr.ndim != 2 or xtr.shape[1] != self.shape.seq_len:
            raise ValueError(
                f"scaled scheme expects a [n, seq_len={self.shape.seq_len}]"
                f" token corpus, got {xtr.shape} — pass data="
                "synthetic_corpus(cfg, n, seq_len) (or let Experiment use "
                "the scheme's default_data)")
        if int(xtr.max(initial=0)) >= self.cfg.vocab_size:
            raise ValueError(
                f"corpus token ids exceed vocab_size={self.cfg.vocab_size}")
        return xtr

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _frontend_extras(self, rng, b: int) -> dict:
        """The stubbed frontends' inputs (vision patches, audio frames),
        drawn from the same rng stream as the token sampling, in the JAX
        package's order (as data/pipeline.py's `synthetic_lm_batches`
        draws them)."""
        cfg, extras = self.cfg, {}
        if cfg.frontend == "vision":
            extras["patch_embeds"] = (b, cfg.n_frontend_tokens, cfg.d_model)
        if cfg.family == "audio":
            extras["frames"] = (b, src_len(cfg, self.shape.seq_len),
                                cfg.d_model)
        return {k: self._tensor(rng.standard_normal(shape).astype(
            np.float32) * 0.1) for k, shape in extras.items()}

    def _sample_batch(self, x, y, rng, b: int) -> dict:
        idx = rng.integers(0, len(x), b)
        return {"tokens": self._tensor(x[idx]),
                "labels": self._tensor(y[idx]),
                **self._frontend_extras(rng, b)}

    # ------------------------------------------------------------- eval
    def _eval_wcfg(self):
        return None      # CL/FL deploy the plain forward

    @torch.no_grad()
    def _evaluate_trainable(self, trainable, xte, yte) -> float:
        """Next-token accuracy of the deployed function on full batches
        of the held-out rows, slice i on key(999 + i) (only SL's link
        draws from it)."""
        cfg, wcfg = self.cfg, self._eval_wcfg()
        window = window_for(cfg, self.shape)
        b = self.shape.global_batch
        rng = np.random.default_rng(EVAL_KEY)      # frontend extras only
        accs = []
        for i in range(0, max(len(xte) - b + 1, 1), b):
            batch = {"tokens": self._tensor(xte[i:i + b]),
                     "labels": self._tensor(yte[i:i + b])}
            batch.update(self._frontend_extras(rng, len(xte[i:i + b])))
            logits, _ = _forward(trainable, batch, cfg, wcfg,
                                 self.key(EVAL_KEY + i), window)
            labels = batch["labels"]
            logits = logits[:, -labels.shape[1]:][:, :-1]
            targets = labels[:, 1:]
            hit = (logits.argmax(dim=-1) == targets).float()
            mask = (targets != 0).float()
            accs.append(float(torch.sum(hit * mask)
                              / torch.clamp(torch.sum(mask), min=1.0)))
        return float(np.mean(accs))

    def default_lr_schedule(self, epoch: int) -> float:
        """Constant 3e-4 when the Experiment pins no schedule: the
        paper's 0.1 step decay is tuned for the 89k-parameter model and
        diverges the scaled archs."""
        return DEFAULT_LR

    # ------------------------------------------------------------ FLOPs
    def _meta_step(self, shape: ShapeConfig) -> None:
        """One optimizer step at `shape` on meta tensors (shapes only)."""
        raise NotImplementedError

    def _micro_count(self, n_data_shards: int) -> int:
        """Microbatches of one optimizer step."""
        return auto_microbatch(self.cfg, self.shape, n_data_shards)

    def _count_flops(self, seq_len: int,
                     shape: Optional[ShapeConfig] = None) -> float:
        """FLOPs of one meta step at `shape` (default the scheme's) cut
        to `seq_len` tokens."""
        from torch.utils.flop_counter import FlopCounterMode
        shape = dataclasses.replace(shape or self.shape, seq_len=seq_len)
        with FlopCounterMode(display=False) as fc:
            self._meta_step(shape)
        return float(fc.get_total_flops())

    # optimizer steps in one round program
    _steps_per_program = 1

    def _program_flops(self, n_data_shards: int) -> float:
        """FLOPs of one round program: one microbatch's meta step, times
        the step's microbatches and the program's steps."""
        n_micro = self._micro_count(n_data_shards)
        b = self.shape.global_batch // n_micro
        one_micro = dataclasses.replace(self.shape, global_batch=b,
                                        microbatch=b)
        S = self.shape.seq_len
        if self.cfg.family == "ssm":
            one = self._count_flops(1, one_micro)
            flops = one + (S - 1) * (self._count_flops(2, one_micro) - one)
        else:
            flops = self._count_flops(S, one_micro)
        return flops * n_micro * self._steps_per_program

    def _step_cost_flops(self) -> float:
        """FLOPs of one round program; cached."""
        if self._cost_flops is None:
            self._cost_flops = self._program_flops(LIVE_DATA_SHARDS)
        return self._cost_flops

    def flops(self, steps_total: int):
        return 0.0, self._step_cost_flops() * steps_total

    # ------------------------------------------------------- lowering
    # kernel libraries (kernels/build.py) the rounds launch on the card
    _kernel_libs: tuple = ()

    def warmup_compile(self) -> float:
        """Build with `nvcc` (where the kernel-build cache lacks them) and
        load every kernel library the rounds launch on this scheme's
        device; returns the wall seconds. No step runs and nothing is
        drawn, so the run after it is unchanged. On the CPU there is
        nothing to build."""
        t0 = time.perf_counter()
        if self.device.type == "cuda" and self._kernel_libs:
            from repro_torch.kernels import build
            build.build_all(self._kernel_libs)
            for name in self._kernel_libs:
                build.load(name)
        return time.perf_counter() - t0

    def _lowered(self, step, state, state_ax, batch, batch_ax, mesh,
                 n_data_shards) -> Lowered:
        metrics = metrics_sds(self.cfg)
        return Lowered(
            step, (state, batch), (state_ax, batch_ax),
            (state, metrics), (state_ax, {k: () for k in metrics}), mesh,
            lambda: self._program_flops(n_data_shards))


# ------------------------------------------------------------------- CL
class ScaledCentralizedScheme(_ScaledScheme):
    """CL for the scaled archs: the corpus crosses the radio once at
    `init` (billed, possibly corrupted), then `steps_per_cycle`
    radio-silent optimizer steps a cycle."""
    mode = "cl"

    def __init__(self, cfg, shape=None, wcfg=None, **kw):
        super().__init__(cfg, shape, wcfg, **kw)
        self._step = make_train_step(cfg, self.shape, self._step_wcfg(),
                                     optimizer=self.optimizer)

    def _step_wcfg(self):
        return None

    def init(self, seed: int, xtr, ytr):
        xtr = self._check_corpus(xtr)
        dlv = self.radio.send_tokens(
            self.key(seed + UPLOAD_STREAM).draws(), self._tensor(xtr),
            self.cfg.vocab_size)
        x_rx = dlv.payload.cpu().numpy()
        state = init_train_state(torch.Generator().manual_seed(seed),
                                 self.cfg, self._step_wcfg(),
                                 self.optimizer, device=self.device)
        # the server trains on what ARRIVED: labels are the received
        # tokens themselves (next-token objective)
        return SchemeState(train=state, data=(x_rx, x_rx)), dlv

    def cycle_batches(self, state, rng, cycle):
        x, y = state.data
        return [self._sample_batch(x, y, rng, self.shape.global_batch)
                for _ in range(self.steps_per_cycle)]

    def round_key(self, seed: int, cycle: int):
        return self.key(seed)

    def round(self, state, batch, key, lr):
        def step(st, b, k):
            return self._step(st, b, k, lr)
        st, m, steps = train_cycle(step, state.train, batch, key,
                                   state.steps)
        new = SchemeState(st, state.data, steps, state.epoch + 1)
        # the corpus upload was billed at init; rounds are radio-silent
        return new, RoundReport(loss=float(m["loss"]),
                                steps=steps - state.steps)

    def evaluate(self, state, xte, yte) -> float:
        return self._evaluate_trainable(state.train.trainable, xte, yte)

    def _meta_step(self, shape: ShapeConfig) -> None:
        wcfg = self._step_wcfg()
        step = make_train_step(self.cfg, shape, wcfg,
                               optimizer=self.optimizer)
        step(train_state_sds(self.cfg, wcfg, self.optimizer),
             M.input_sds(self.cfg, shape), key_sds(), DEFAULT_LR)

    def lower_step(self, mesh, n_data_shards: Optional[int] = None):
        """The round's train step readied for `mesh` (launch/dryrun.py's
        input), with `n_data_shards` data shards for its microbatching
        (default the live step's)."""
        nd = n_data_shards or LIVE_DATA_SHARDS
        wcfg = self._step_wcfg()
        step = make_train_step(self.cfg, self.shape, wcfg,
                               optimizer=self.optimizer, n_data_shards=nd)
        return self._lowered(
            step, train_state_sds(self.cfg, wcfg, self.optimizer),
            train_state_axes(self.cfg, wcfg, self.optimizer),
            M.input_sds(self.cfg, self.shape),
            M.input_axes(self.cfg, self.shape), mesh, nd)


# ------------------------------------------------------------------- SL
class ScaledSplitScheme(ScaledCentralizedScheme):
    """SL for the scaled archs: each optimizer step pushes every
    microbatch's encoded activation up and its tau-clipped gradient
    down through the radio (K1 per leg on the card), billed at the
    DRAWN ARQ counts replayed from the same keys."""
    mode = "sl"
    _kernel_libs = ("quant_channel",)      # K1, each leg

    def __init__(self, cfg, shape=None, wcfg=None, perfect_eval=False,
                 **kw):
        wcfg = wcfg or WirelessConfig(mode="sl", quant_bits=16)
        super().__init__(cfg, shape, wcfg, **kw)
        self.perfect_eval = perfect_eval
        self._n_micro = auto_microbatch(cfg, self.shape)
        # one leg's payload per optimizer step (all microbatches)
        self._leg_elems = SPLIT.crossing_elems(cfg, self.shape, wcfg)

    def _step_wcfg(self):
        return self.wcfg

    def _eval_wcfg(self):
        if self.perfect_eval:
            return dataclasses.replace(self.wcfg, perfect_channel=True)
        return self.wcfg

    def init(self, seed: int, xtr, ytr):
        xtr = self._check_corpus(xtr)
        state = init_train_state(torch.Generator().manual_seed(seed),
                                 self.cfg, self.wcfg, self.optimizer,
                                 device=self.device)
        return SchemeState(train=state, data=(xtr, xtr)), None

    def _drawn_leg_diag(self, key, start: int, n_steps: int):
        """(n_tx, n_erased_legs, backoff_units) of `n_steps` steps from
        cumulative step `start`: microbatch i of step s crosses on
        key.fold_in(s).fold_in(i), its gradient leg on that .fold_in(1);
        the "arq" draw of each leg is replayed. (2 x n_micro x n_steps,
        0, 0) on a fault-free link, with no draw."""
        radio = self.radio
        if n_steps <= 0:
            return 0.0, 0.0, 0.0
        if W.fault_free(radio.fading, radio.perfect, radio.arq_attempts,
                        radio.arq_min_f2, radio.arq_max_tx,
                        radio.ge_p_gb):
            return float(2 * self._n_micro * n_steps), 0.0, 0.0
        kw = dict(fading=radio.fading, perfect=False,
                  arq_attempts=radio.arq_attempts,
                  arq_min_f2=radio.arq_min_f2,
                  arq_max_tx=radio.arq_max_tx,
                  ge_p_gb=radio.ge_p_gb, ge_p_bg=radio.ge_p_bg)
        tx = er = 0
        bo = np.float32(0.0)
        for s in range(start, start + n_steps):
            for i in range(self._n_micro):
                ck = key.fold_in(s).fold_in(i)
                for leg in (ck, ck.fold_in(1)):
                    t, e, b = W.drawn_tree_diag(leg.draws(), 1, **kw)
                    tx, er, bo = tx + t, er + e, bo + np.float32(b)
        return float(tx), float(er), float(bo)

    def round(self, state, batch, key, lr):
        new, rep = super().round(state, batch, key, lr)
        n = rep.steps
        n_tx, n_er, bo = self._drawn_leg_diag(key, state.steps, n)
        # each microbatch leg carries leg_elems / n_micro elements
        leg_bits = (self._leg_elems / self._n_micro) \
            * float(self.radio.quant_bits)
        bits = n_tx * leg_bits
        return new, RoundReport(
            loss=rep.loss, steps=n, bits=bits, n_tx=n_tx,
            energy_j=self.radio.energy_j(bits),
            erased_bits=n_er * self.radio.arq_max_tx * leg_bits,
            outage_s=bo * self.radio.arq_backoff_s)

    def flops(self, steps_total: int):
        """One step covers both sides of the cut; apportioned by layer
        share — `cut` of `n_layers` on the user, the rest the server's."""
        total = self._step_cost_flops() * steps_total
        cut = max(1, min(self.wcfg.split_layer, self.cfg.n_layers - 1))
        ufrac = cut / float(self.cfg.n_layers)
        return total * ufrac, total * (1.0 - ufrac)


# ------------------------------------------------------------------- FL
class ScaledFederatedScheme(_ScaledScheme):
    """One `round` runs `make_fl_train_step`'s whole cycle (J local
    SGD-momentum steps per user + the quantized stacked sync); the sync
    is billed by replaying its fade/ARQ draw on `key.fold_in(999)`, one
    packet per (user, trainable leaf) — 14 leaves for qwen1.5-0.5b,
    whose layers are stacked. Bits are reported per user.

    `wcfg.sync="delayed"` runs the one-cycle-staleness schedule: the
    scheme state becomes the carry {"state", "agg"}; the bill is the
    barrier one's (the same packets cross); `evaluate` deploys the
    aggregate (the server's weights)."""
    mode = "fl"
    _kernel_libs = ("quant_channel",)      # the sync: K1, or K2

    def __init__(self, cfg, shape=None, wcfg=None, **kw):
        kw.pop("steps_per_cycle", None)   # one cycle IS local_steps steps
        if kw.get("optimizer", "sgd") != "sgd":
            raise ValueError("ScaledFederatedScheme runs SGD-momentum "
                             f"local steps; optimizer="
                             f"{kw['optimizer']!r} is not supported")
        kw["optimizer"] = "sgd"
        wcfg = wcfg or WirelessConfig(mode="fl")
        super().__init__(cfg, shape, wcfg, **kw)
        self.n_users = wcfg.n_users
        self.local_steps = wcfg.local_steps
        self.sync = str(wcfg.sync)
        self.bits_normalizer = float(self.n_users)
        self._step = make_fl_train_step(cfg, self.shape, wcfg,
                                        n_users=self.n_users)
        # per-packet payload of the stacked sync: one packet per
        # (user, model leaf), sized by the per-user leaf
        self._packet_sizes = packet_sizes(cfg)

    def _as_train(self, user_states):
        if self.sync != "delayed":
            return user_states
        return {"state": user_states,
                "agg": user_states.trainable["model"]}

    def init(self, seed: int, xtr, ytr):
        xtr = self._check_corpus(xtr)
        ytr = np.asarray(ytr)
        state0 = init_train_state(torch.Generator().manual_seed(seed),
                                  self.cfg, None, "sgd", device=self.device)
        train = self._as_train(FED.broadcast_state(state0, self.n_users))
        per = len(xtr) // self.n_users
        shards = [(xtr[u * per:(u + 1) * per], ytr[u * per:(u + 1) * per])
                  for u in range(self.n_users)]
        return SchemeState(train=train, data=shards), None

    def cycle_batches(self, state, rng, cycle):
        b = self.shape.global_batch
        per_user = [self._sample_batch(xs, ys, rng, b)
                    for xs, ys in state.data]
        return {k: torch.stack([u[k] for u in per_user])
                for k in per_user[0]}

    def round_key(self, seed: int, cycle: int):
        return self.key(seed + FL_STREAM).fold_in(cycle)

    def round(self, state, batch, key, lr):
        st, metrics = self._step(state.train, batch, key, lr)
        r = self.radio
        out = W.drawn_stacked_tx(
            key.fold_in(SYNC_KEY_FOLD).draws(), self.n_users,
            len(self._packet_sizes), fading=r.fading, perfect=r.perfect,
            arq_attempts=r.arq_attempts, arq_min_f2=r.arq_min_f2,
            arq_max_tx=r.arq_max_tx, ge_p_gb=r.ge_p_gb,
            ge_p_bg=r.ge_p_bg, with_erased=(r.arq_max_tx > 0))
        erased_bits = 0.0
        if r.arq_max_tx > 0:
            n_tx, erased = out
            erased_bits = float(r.wire_width()) * float(
                (self._packet_sizes[None, :] * n_tx * erased).sum())
        else:
            n_tx = out
        # billed at the on-wire width: quant_bits for float32 symbols,
        # the container width for int8/int4 packed codewords
        bits = float(r.wire_width()) * float(
            (self._packet_sizes[None, :] * n_tx).sum())
        new = SchemeState(st, state.data, state.steps + self.local_steps,
                          state.epoch + 1)
        return new, RoundReport(
            loss=float(metrics["loss"]), steps=self.local_steps,
            bits=bits, n_tx=float(n_tx.sum()), energy_j=r.energy_j(bits),
            erased_bits=erased_bits,
            outage_s=float(W.backoff_s(n_tx, r.arq_backoff_s)))

    def flops(self, steps_total: int):
        """All FLOPs are the users' (the server only averages)."""
        cycles = steps_total / float(max(self.local_steps, 1))
        return self._step_cost_flops() * cycles, 0.0

    @property
    def _steps_per_program(self) -> int:
        # a cycle's local phase; the sync has no matmul
        return self.n_users * self.local_steps

    def _micro_count(self, n_data_shards: int) -> int:
        return 1             # a local step takes the whole batch

    def _meta_step(self, shape: ShapeConfig) -> None:
        make_local_step(self.cfg, DEFAULT_LR)(
            train_state_sds(self.cfg, None, "sgd"),
            M.input_sds(self.cfg, shape))

    def lower_step(self, mesh, n_data_shards: Optional[int] = None):
        """The whole FL cycle readied for `mesh`, the user axis leading
        every state and batch leaf ("users" resolves to `pod`).
        `n_data_shards` is accepted for launch/dryrun.py's call and
        unused: a local step takes its whole batch."""
        n = self.n_users
        state_ax = train_state_axes(self.cfg, None, "sgd", n_users=n)
        batch = {k: v.new_empty((n,) + tuple(v.shape)) for k, v in
                 M.input_sds(self.cfg, self.shape).items()}
        batch_ax = {k: ("users",) + ax for k, ax in
                    M.input_axes(self.cfg, self.shape).items()}
        return self._lowered(
            self._step,
            self._as_train(train_state_sds(self.cfg, None, "sgd",
                                           n_users=n)),
            self._as_train(state_ax), batch, batch_ax, mesh, n)

    def evaluate(self, state, xte, yte) -> float:
        if self.sync == "delayed":
            st = state.train["state"]
            trainable = dict(st.trainable, model=state.train["agg"])
        else:
            trainable = state.train.trainable
        return self._evaluate_trainable(tree_map(lambda p: p[0], trainable),
                                        xte, yte)


def packet_sizes(cfg) -> np.ndarray:
    """Element count of each trainable model leaf in the wire's order
    (sorted keys, layers stacked): the per-user packets of the FL sync."""
    return np.asarray([float(np.prod(s.shape))
                       for s in tree_leaves(M.train_param_specs(cfg))],
                      np.float64)
