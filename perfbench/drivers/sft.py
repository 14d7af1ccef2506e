"""LoRA fine-tuning: Trainer.train on GraphLM.loss over MolQA records.

Set-up builds the model from the configuration (weights drawn on the card
from the seed; the flash route on, so kernel E carries attention), makes
the records from the seed and the traffic file, tokenizes them through
the port's template, aligner and processor, builds the Trainer (AdamW,
accumulation, clipping, the warmup-cosine schedule) and drives that same
trainer through its first three optimizer updates with the window's own
call and feed: these steps are what the reference follows. The window
then calls Trainer.train on a batch iterator that stops when the window
closes; each batch is collated by the port's SeqGraphCollator on the
trainer's prefetch thread. The Trainer calls the benchmark's own loss
function (GraphLM.loss on the batch), which keeps each micro step's loss
terms on the card; nothing inside the Trainer is wrapped.

Training tokens per second count the real (attention-mask) tokens of
every micro step run in the window over the time from the window's start
to the end of its last micro step; the peak is max_memory_allocated over
the window.

The design branch's noised graph is an input: the benchmark draws it from
the seed for each batch and hands it to the loss (GraphLM.loss noisy=) and
to the reference alike. Its condition dropout and property noise are the
program's draws from the trainer's generator, which the reference makes
again, in the program's order, from a generator seeded alike.

Compared after the window (perfbench/reference/, float32, TF32 off):
  lm_loss_gap, design_loss_gap, retro_loss_gap  each term of each of the
      six micro steps, |program - reference| / |reference|, the worst
  grad_gap    the first update's gradient as AdamW got it (its first
              moment / (1 - b1)), by the worst leaf: |norm - reference
              norm| / max(reference leaf norm, median leaf norm)
  update_gap  the change of each leaf over the three updates, alike,
              over the leaves whose first gradient is not nought to
              rounding in the reference (over a thousandth of the median)
The share of trainable elements those updates moved is a note
(moved_share).
"""

import collections
import gc
import math
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import core, program, trace as tracing, traffic as gen_traffic
from .. import weights as wdraw
from ..reference import graph as ref_graph
from ..reference.llm import Decoder

IGNORE = -100
NO_LABEL = -200
CHECK_MICRO_STEPS = 6


def noised_design(batch, active, dx, de, T, rng):
    """The benchmark's noise for a batch's design graphs: t ~ U{0..T}, each
    node and bond keeps its class with probability alpha_bar(t), else takes
    a uniform one. -> {"t", "X_t", "E_t"} as numpy."""
    b = batch["input_ids"].shape[0]
    idx = np.clip(batch["design_graph_index"], 0, None)
    valid = (batch["design_start_pos"] >= 0) & (batch["design_graph_index"]
                                                >= 0)
    atoms = batch["mol_atoms"][idx]
    edges = batch["mol_edges"][idx]
    mask = batch["mol_node_mask"][idx] & valid[:, None]
    n = atoms.shape[1]
    code_to_col = {c: i for i, c in enumerate(active)}
    t_int = rng.integers(0, T + 1, size=b)
    keep = ref_graph.alphas_bar(T)[t_int]
    xa = np.vectorize(lambda c: code_to_col.get(int(c), -1))(atoms)
    rand_x = rng.integers(0, dx, size=(b, n))
    xa = np.where(rng.random((b, n)) < keep[:, None], np.maximum(xa, 0),
                  rand_x)
    X = np.eye(dx, dtype=np.float32)[xa] * mask[..., None]
    rand_e = rng.integers(0, de, size=(b, n, n))
    e = np.where(rng.random((b, n, n)) < keep[:, None, None], edges, rand_e)
    e = np.triu(e, 1)
    e = e + e.transpose(0, 2, 1)
    pair = mask[:, :, None] & mask[:, None, :]
    E = np.eye(de, dtype=np.float32)[e] * pair[..., None]
    return {"t": (t_int / T).astype(np.float32), "X_t": X, "E_t": E}


class Feed:
    """The batches of the run in order: records paired into micro
    batches, collated by the port's collator when asked for (the
    collate span), each with its noised design graphs; `until` stops the
    stream at a time."""

    def __init__(self, inputs, collator, rows, seed, active, dx, de, T):
        self.inputs, self.collator, self.rows = inputs, collator, rows
        self.seed, self.active, self.dx, self.de, self.T = (seed, active, dx,
                                                             de, T)
        self.k = 0
        self.noise = collections.deque()
        self.collate_s = []          # (start, end) of each collate call
        self.batches = []            # kept for the reference (first ones)

    def next_batch(self, keep=False):
        n = len(self.inputs)
        feats = [self.inputs[(self.k * self.rows + i) % n]
                 for i in range(self.rows)]
        t0 = time.monotonic()
        batch = self.collator(feats)
        self.collate_s.append((t0, time.monotonic()))
        rng = np.random.default_rng([self.seed, self.k, 7])
        noisy = noised_design(batch, self.active, self.dx, self.de, self.T,
                              rng)
        self.noise.append(noisy)
        if keep:
            self.batches.append((batch, noisy))
        self.k += 1
        return batch

    def stream(self, count=None, until=None, keep=False):
        i = 0
        while (count is None or i < count) and (until is None
                                                or time.monotonic() < until):
            yield self.next_batch(keep)
            i += 1


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, control: bool = False) -> core.Run:
    from llamole_tpu_torch.chem.featurize import smiles_to_graph
    from llamole_tpu_torch.config.args import TrainingArguments
    from llamole_tpu_torch.data.aligner import align_dataset
    from llamole_tpu_torch.data.collator import SeqGraphCollator
    from llamole_tpu_torch.data.loader import build_graph_bank
    from llamole_tpu_torch.data.processor import preprocess_examples
    from llamole_tpu_torch.data.template import get_template
    from llamole_tpu_torch.ops import flash_attention as flash_mod
    from llamole_tpu_torch.train.trainer import Trainer

    cfg, tr = cell.config, cell.traffic
    dev = device or torch.device("cuda")
    on_card = dev.type == "cuda"
    res = core.Run()
    setup = {}
    t = time.monotonic()
    if on_card:
        from llamole_tpu_torch.ops import cuda_lib
        cuda_lib.library()
    setup["library_s"] = time.monotonic() - t
    data = gen_traffic.load_data()
    model, tok, spec = program.build(cfg, seed, dev, data["molecules"],
                                     tr["lora_b_std"], setup)
    t = time.monotonic()
    nb = cfg["learned_query_size"]
    template = get_template(cfg["template"], tok)
    cutoff = tr["cutoff_len"]
    records = gen_traffic.training_records(seed, tr, data)
    examples, id_to_smiles = align_dataset(records, nb)
    bank = build_graph_bank(id_to_smiles)
    inputs = preprocess_examples(examples, template, tok, cutoff)
    rows = tr["rows"]
    collator = SeqGraphCollator(
        tokenizer=tok, mol_id_to_graph=bank, max_len=cutoff,
        max_nodes=cfg["graphdit"]["max_n_nodes"],
        max_graphs=max(8, rows * 8), max_retro=max(8, rows * 8),
        pad_to_multiple_of=tr["pad_to_multiple_of"])
    corpus = [smiles_to_graph(s) for s in data["molecules"]]
    active = sorted({int(a) for g in corpus for a in g.atom_types})
    dit = cfg["graphdit"]
    dx, de, T = len(active), dit["Edim"], dit["diffusion_steps"]
    feed = Feed(inputs, collator, rows, seed, active, dx, de, T)
    setup["data_s"] = time.monotonic() - t

    t = time.monotonic()
    args = TrainingArguments(
        per_device_train_batch_size=rows,
        gradient_accumulation_steps=tr["gradient_accumulation_steps"],
        learning_rate=tr["learning_rate"],
        lr_scheduler_type=tr["lr_scheduler_type"],
        warmup_ratio=tr["warmup_ratio"], logging_steps=tr["logging_steps"],
        save_steps=0, seed=seed, bf16=True, pure_bf16=True)

    # the benchmark's loss function, which the Trainer calls once a micro
    # step: it keeps each micro step's loss terms (on the device) and
    # shape, and with --trace 1 marks the traced units' boundaries (a
    # unit runs from one call to the next: forward, backward, the
    # optimizer's accumulate and the wait for the next batch)
    steps = []                  # (loss, aux) tensors of every micro step
    step_shapes = []            # (width, real lengths) of every micro step
    marks = []                  # called at each micro step's start

    def loss_fn(batch, gen):
        for mark in marks:
            mark()
        step_shapes.append((int(batch["input_ids"].shape[1]),
                            [int(v) for v in batch["attention_mask"].sum(1)]))
        noisy = feed.noise.popleft()
        noisy = {k: torch.as_tensor(v, device=dev) for k, v in noisy.items()}
        loss, aux = model.loss(batch, gen, train=True, noisy=noisy)
        steps.append((loss.detach(), {k: v.detach() for k, v in aux.items()}))
        return loss, aux

    trainer = Trainer(loss_fn, model.trainable_parameters(), args,
                      tr["training_steps"])
    state = trainer.init_state(seed)
    p0 = {n: p.detach().clone() for n, p in trainer.params.items()}
    accum = tr["gradient_accumulation_steps"]
    state, _ = trainer.train(state, feed.stream(accum, keep=True), accum)
    b1 = trainer.optimizer.b1
    g1 = {n: (m.float() / (1.0 - b1)).clone()
          for n, m in trainer.optimizer.mu.items()}
    state, _ = trainer.train(state, feed.stream(CHECK_MICRO_STEPS - accum,
                                                keep=True),
                             CHECK_MICRO_STEPS)
    p3 = {n: p.detach().clone() for n, p in trainer.params.items()}
    checked = [(float(loss), {k: float(v) for k, v in aux.items()})
               for loss, aux in steps]
    setup["first_steps_s"] = time.monotonic() - t

    spans = tracer = None
    if trace:
        spans = core.Spans(sync=on_card)
        tracer = tracing.UnitTracer(tr["trace"]["skip"], tr["trace"]["units"])
        counts = {}
        started = []

        def mark():
            if started:
                tracer.end()
            if tracer.done and "t1" not in counts:
                counts["t1"] = (len(step_shapes), flash_counts(flash_mod))
            if tracer.seen == tracer.skip and "t0" not in counts:
                counts["t0"] = (len(step_shapes), flash_counts(flash_mod))
            tracer.begin()
            started.append(True)

        marks.append(mark)
        spans.wrap(model, "loss", "graph_lm_loss")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    res.e2e["setup_s"] = time.monotonic() - t_start

    first_window_step = len(steps)
    t0 = time.monotonic()
    micro_before = len(feed.collate_s)
    state, metrics = trainer.train(state, feed.stream(until=t0 + seconds),
                                   10 ** 12)
    if on_card:
        torch.cuda.synchronize()
    t1 = time.monotonic()
    window_steps = metrics["step_times"]
    tokens = sum(s["tokens"] for s in window_steps)
    res.e2e["train_tokens_per_s"] = tokens / (t1 - t0)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    res.e2e["train_peak_gib"] = peak / 2 ** 30
    res.attempted = len(window_steps)
    res.failed = sum(1 for loss, _ in steps[first_window_step:]
                     if not math.isfinite(float(loss)))
    res.counters = {"micro_steps": len(window_steps), "tokens": tokens,
                    "window_s": t1 - t0, "setup_split": setup,
                    "step_split": {k: statistics.mean(s[k] for s in
                                                      window_steps)
                                   for k in ("forward_s", "backward_s",
                                             "optimizer_s")}
                    if window_steps else {}}
    if trace:
        res.counters["flash"] = counts
    res.spans = spans
    if spans is not None:
        spans.record_all("collate", feed.collate_s[micro_before:])
    res.shapes = {"batches": step_shapes[first_window_step:],
                  "window_s": t1 - t0, "tokens": tokens,
                  "llm": program.llm_fields(cfg), "graphdit": dit,
                  "xdim": dx, "graphclip": cfg["graphclip"],
                  "predictor": cfg["predictor"], "rows": rows,
                  "llm_params": sum(p.numel() for n, p in
                                    model.llm.named_parameters()
                                    if not n.startswith("embed.")
                                    and "lora_" not in n)}
    if tracer is not None:
        res.trace = tracer.reduce(spans.log)
        if res.trace is not None and "t0" in counts and "t1" in counts:
            res.trace["flash_launches"] = {
                k: counts["t1"][1][k] - counts["t0"][1][k]
                for k in counts["t0"][1]}
            res.trace["batches"] = step_shapes[counts["t0"][0]:
                                               counts["t1"][0]]
    if on_card:
        res.device = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(dev), "count": 1,
                      "memory_peak_bytes": torch.cuda.max_memory_allocated(
                          dev)}
        if res.trace is not None:
            res.device["busy_s"] = res.trace["busy_s"]
            res.device["window_s"] = res.trace["window_s"]
    if spans is not None:
        spans.unwrap()

    # the program's readings, then its state freed
    prog = {"losses": checked[:CHECK_MICRO_STEPS],
            "g1": {n: v.cpu() for n, v in g1.items()},
            "delta": {n: (p3[n].float() - p0[n].float()).cpu() for n in p0},
            "dtypes": {n: p.dtype for n, p in trainer.params.items()}}
    moved = sum(int((d != 0).sum()) for d in prog["delta"].values())
    res.notes["moved_share"] = moved / max(sum(d.numel() for d in
                                               prog["delta"].values()), 1)
    res.notes["trainable_dtypes"] = sorted({str(d) for d in
                                            prog["dtypes"].values()})
    batches = feed.batches[:CHECK_MICRO_STEPS]
    del trainer, state, model, feed, p0, p3, g1
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.monotonic()
    judge(res, cell, seed, spec, dev, batches, prog, active, args, control)
    res.notes["reference_s"] = time.monotonic() - t
    return res


def flash_counts(flash_mod) -> dict:
    fa = flash_mod.flash_attention
    return {k: int(getattr(fa, k)) for k in ("launches_fwd", "launches_dq",
                                             "launches_dkv")}


# ---------------------------------------------------------------------------
# the plain reference: three optimizer updates in float32
# ---------------------------------------------------------------------------

class Reference:
    """The float32 reference of GraphLM.loss and AdamW over the benchmark's
    draws. quantize / tf32: the control's lower precisions; half: drop the
    second half of every batch's rows (a planted fault)."""

    def __init__(self, cfg, spec, seed, dev, total, quantize=None,
                 tf32=False, half=False):
        self.cfg, self.dev, self.tf32, self.half = cfg, dev, tf32, half
        self.total = total
        w = wdraw.tensors(spec, seed, dev)
        self.trainable = [n for n in w if "lora_" in n
                          or n.startswith("connectors.")]
        for n in self.trainable:
            w[n] = w[n].detach().clone().requires_grad_(True)
        self.w = w
        self.dec = Decoder(program.llm_fields(cfg), w, program.lora_scale(cfg),
                           quantize=quantize)
        self.nb = cfg["learned_query_size"]
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.draws = ref_graph.generator_draws(self.gen, dev)

    def t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.dev, dtype=dtype)

    def loss(self, batch, noisy, active):
        """(total, lm, design, retro) of one collated batch."""
        cfg, w, nb = self.cfg, self.w, self.nb
        b_all = batch["input_ids"].shape[0]
        keep = list(range(b_all // 2 if self.half else b_all))
        clip = cfg["graphclip"]
        with ref_graph.precision(self.tf32):
            mol = ref_graph.graphclip(w, self.t(batch["mol_atoms"]),
                                      self.t(batch["mol_edges"]),
                                      self.t(batch["mol_node_mask"],
                                             torch.bool), clip["num_layer"])
            mol = F.silu(ref_graph.linear(w, "connectors.graph_to_lm", mol))
        nll, count = 0.0, 0
        design_h, retro_h = {}, {}
        for r in keep:
            n = int(batch["attention_mask"][r].sum())
            ids = self.t(batch["input_ids"][r, :n], torch.long)
            x = self.dec.embed(ids)
            slots = [(m, int(c)) for m, (rr, c, v) in enumerate(zip(
                batch["mol_rows"], batch["mol_cols"], batch["mol_valid"]))
                if v and rr == r and c < n]
            if slots:
                idx = torch.tensor([c for _, c in slots], device=self.dev)
                x = x.index_put((idx,), mol[[m for m, _ in slots]])
            with ref_graph.precision(False):
                hidden = self.dec.hidden(x, recompute=True)
                logits = self.dec.logits(hidden)
            labels = self.t(batch["labels"][r, 1:n], torch.long)
            valid = labels != IGNORE
            nll = nll + F.cross_entropy(logits[:-1][valid], labels[valid],
                                        reduction="sum")
            count += int(valid.sum())
            ds = int(batch["design_start_pos"][r])
            design_h[r] = hidden[[min(max(ds, 0) + 1 + i, n - 1)
                                  for i in range(nb)]].mean(0)
            for e, (rr, c, v) in enumerate(zip(batch["retro_rows"],
                                               batch["retro_cols"],
                                               batch["retro_valid"])):
                if v and rr == r:
                    retro_h[e] = hidden[[min(int(c) + 1 + i, n - 1)
                                         for i in range(nb)]].mean(0)
        lm = nll / max(count, 1)
        with ref_graph.precision(self.tf32):
            design = self._design(batch, noisy, design_h, active, b_all)
            retro = self._retro(batch, retro_h)
        return lm + design + retro, lm, design, retro

    def _design(self, batch, noisy, design_h, active, b_all):
        cfg, w = self.cfg, self.w
        dit = cfg["graphdit"]
        h = torch.stack([design_h.get(r, torch.zeros_like(
            next(iter(design_h.values())))) for r in range(b_all)])
        cond = F.silu(ref_graph.linear(w, "connectors.lm_to_graph_decoder",
                                       h))
        d_idx = np.clip(batch["design_graph_index"], 0, None)
        d_valid = ((batch["design_start_pos"] >= 0)
                   & (batch["design_graph_index"] >= 0))
        for r in range(b_all):
            if r not in design_h:     # a row left out (the planted fault)
                d_valid[r] = False
        mask = self.t(batch["mol_node_mask"][d_idx] & d_valid[:, None],
                      torch.bool)
        atoms = batch["mol_atoms"][d_idx]
        col = {c: i for i, c in enumerate(active)}
        act = self.t(np.vectorize(lambda c: col.get(int(c), -1))(atoms),
                     torch.long)
        X, E = ref_graph.one_hot_graph(act, self.t(batch["mol_edges"][d_idx],
                                                   torch.long), mask,
                                       len(active), dit["Edim"])
        props = self.t(batch["molecule_properties"], torch.float32)
        y = torch.where(props == NO_LABEL, float("nan"), props)
        dcfg = dict(dit)
        px, pe = ref_graph.denoiser(
            w, self.t(noisy["X_t"]), self.t(noisy["E_t"]), mask, y, cond,
            self.t(noisy["t"]), dcfg, draws=self.draws)
        return ref_graph.diffusion_ce(px, pe, X, E, dit["lambda_train"])

    def _retro(self, batch, retro_h):
        cfg, w = self.cfg, self.w
        if not retro_h:
            return torch.zeros((), device=self.dev)
        ents = sorted(retro_h)
        h = torch.stack([retro_h[e] for e in ents])
        cond = F.silu(ref_graph.linear(
            w, "connectors.lm_to_graph_predictor", h))
        sel = np.asarray(ents)
        logits = ref_graph.predictor(
            w, self.t(batch["retro_atoms"][sel]),
            self.t(batch["retro_edges"][sel]),
            self.t(batch["retro_node_mask"][sel], torch.bool), cond,
            cfg["predictor"]["num_layer"])
        labels = self.t(batch["retro_labels"][sel], torch.long).clamp(
            0, logits.shape[-1] - 1)
        return F.cross_entropy(logits, labels, reduction="mean")

    def run(self, batches, active, args, dtypes):
        """Losses of each micro step, the first update's gradient by leaf
        and each leaf's change over the updates."""
        params = {n: self.w[n] for n in self.trainable}
        start = {n: p.detach().clone() for n, p in params.items()}
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        acc = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, g1 = [], None
        k = args.gradient_accumulation_steps
        count = 0
        for i, (batch, noisy) in enumerate(batches):
            total, lm, design, retro = self.loss(batch, noisy, active)
            grads = torch.autograd.grad(total, list(params.values()),
                                        allow_unused=True)
            losses.append((float(total.detach()), {
                "lm_loss": float(lm.detach()),
                "design_loss": float(design.detach()),
                "retro_loss": float(retro.detach())}))
            for (n, _), g in zip(params.items(), grads):
                if g is not None:
                    acc[n] += g.detach() / k
            if (i + 1) % k:
                continue
            norm = torch.sqrt(sum((g * g).sum() for g in acc.values()))
            scale = (args.max_grad_norm / norm
                     if norm >= args.max_grad_norm else 1.0)
            count += 1
            c1, c2 = 1 - args.adam_beta1 ** count, 1 - args.adam_beta2 ** count
            with torch.no_grad():
                for n, p in params.items():
                    g = acc[n] * scale
                    mu[n].mul_(args.adam_beta1).add_((1 - args.adam_beta1) * g)
                    nu[n].mul_(args.adam_beta2).add_((1 - args.adam_beta2)
                                                     * g * g)
                    upd = (mu[n] / c1) / (torch.sqrt(nu[n] / c2)
                                          + args.adam_epsilon)
                    new = p - schedule(args, self.total, count - 1) * upd
                    # each leaf kept in the program's dtype for it
                    p.copy_(new.to(dtypes[n]).float())
                if g1 is None:
                    g1 = {n: (acc[n] * scale).clone() for n in params}
                for a in acc.values():
                    a.zero_()
        delta = {n: (p.detach() - start[n]).cpu() for n, p in params.items()}
        return losses, {n: v.cpu() for n, v in g1.items()}, delta


def schedule(args, total, count):
    """The learning rate of update `count` (from 0): a linear warmup from
    0 over warmup_ratio of the updates, then a cosine decay to 0."""
    peak = args.learning_rate
    w = max(int(args.warmup_ratio * total), 1)
    decay = max(total, w + 1)
    if count < w:
        return peak * count / w
    frac = min(count - w, decay - w) / (decay - w)
    return peak * 0.5 * (1.0 + math.cos(math.pi * frac))


def leaf_gap(got, want, leaves):
    """The worst leaf's |norm(got) - norm(want)| / max(norm(want), median
    leaf norm of want)."""
    norms = {n: float(want[n].float().norm()) for n in leaves}
    med = statistics.median(norms.values())
    worst = 0.0
    for n in leaves:
        gap = abs(float(got[n].float().norm()) - norms[n])
        worst = max(worst, gap / max(norms[n], med, 1e-30))
    return worst


def readings(side, ref, g1_ref):
    """The compared numbers of one side (program or a control) against
    the reference."""
    out = {}
    for key in ("lm_loss", "design_loss", "retro_loss"):
        out[f"{key}_gap"] = max(abs(s[1][key] - r[1][key])
                                / max(abs(r[1][key]), 1e-30)
                                for s, r in zip(side["losses"],
                                                ref["losses"]))
    leaves = sorted(g1_ref)
    out["grad_gap"] = leaf_gap(side["g1"], g1_ref, leaves)
    norms = {n: float(g1_ref[n].norm()) for n in leaves}
    med = statistics.median(norms.values())
    moved = [n for n in leaves if norms[n] > 1e-3 * med]
    out["update_gap"] = leaf_gap(side["delta"], ref["delta"], moved)
    out["leaves_compared"] = len(moved)
    return out


def judge(res, cell, seed, spec, dev, batches, prog, active, args,
          control=False):
    cfg, lim = cell.config, cell.limits
    dtypes = prog["dtypes"]
    total = cell.traffic["training_steps"]
    ref = Reference(cfg, spec, seed, dev, total)
    losses, g1, delta = ref.run(batches, active, args, dtypes)
    want = {"losses": losses, "delta": delta}
    del ref
    gc.collect()
    got = readings(prog, want, g1)
    for key in ("lm_loss_gap", "design_loss_gap", "retro_loss_gap",
                "grad_gap", "update_gap"):
        res.check(key, got[key], lim[key])
    res.notes["leaves_compared"] = got["leaves_compared"]
    if not control:
        return
    ctrl = {}
    for name, kw in (("int8", {"quantize": "int8", "tf32": True}),
                     ("half_batch", {"half": True})):
        side = Reference(cfg, spec, seed, dev, total, **kw)
        l2, g2, d2 = side.run(batches, active, args, dtypes)
        del side
        gc.collect()
        ctrl[name] = readings({"losses": l2, "g1": g2, "delta": d2}, want, g1)
    res.notes["control"] = ctrl
