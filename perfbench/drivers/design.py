"""Design serving: a closed loop of clients over DesignServer.

Set-up builds the model from the configuration (weights drawn on the card
from the seed), starts DesignServer with the traffic's batch size, wait
and generation settings, and serves one warm-up batch of the cell's own
shapes. In the window `clients` closed-loop clients each submit a
request, wait for its answer and submit the next, until the window
closes; the requests in flight then finish. Latency is the benchmark's
clock from submit to answer, for every request submitted in the window;
throughput counts the answers without error over the time from the
window's start to the last answer.

What the timed path produced is kept as it goes, through the program's
public methods (the prompt ids and the tokens each LLM.generate call
returned, the design condition handed to GraphDiT.generate, the
denoiser's inputs and outputs at reverse steps drawn from the seed), and
judged after the window against the plain float32 reference
(perfbench/reference/), once the program is freed:

  prompt_mismatch  judged rows whose prompt (or rollback prompt) ids are
                   not the reference's tokenization of what was sent
  sampled_outside  served tokens the reference's sampler could not have
                   drawn: below the least logit of its top-p candidate set
                   by more than the limits' sampled_margin (in logits)
  cond_err         the design condition's relative error: the LLM's
                   hidden states through the decode cache and the query
                   extension, then the connector
  denoiser_err     the denoiser output's relative error at the drawn steps

The stop token a row picked is not returned by LLM.generate, so it is
not judged; nor are the program's logits themselves (PERF.md).
"""

import collections
import gc
import math
import random
import time

import torch

from .. import core, program, trace as tracing, traffic as gen_traffic
from ..reference import graph as ref_graph
from ..reference import tokens as ref_tokens
from ..reference.llm import Decoder


def p_quantile(values, q):
    """Nearest-rank quantile q of values (inf counts as the largest)."""
    s = sorted(values)
    return s[max(math.ceil(q * len(s)) - 1, 0)]


class Capture:
    """Readings of the timed path, taken from outside the program through
    its public methods: LLM.generate is wrapped to keep each call's prompt
    ids, mask and the tokens it returns; GraphDiT.generate to keep the
    design condition; GraphLM.design_molecule to count batches; a forward
    hook on the denoiser keeps its inputs and outputs at the drawn reverse
    steps of the first window batches. Everything stays on the device
    until the window has closed (no synchronisation is added inside it);
    `finish` then moves it to the host."""

    def __init__(self, model, denoiser_steps):
        self.model = model
        self.steps_wanted = denoiser_steps      # [step of batch 0, 1, ...]
        self.batch = -1
        self.calls, self.conds, self.denoised = [], [], []
        self.recording = True
        self._step = 0
        self._orig_generate = model.llm.generate
        self._orig_dit = model.graph_decoder.generate
        self._orig_design = model.design_molecule
        model.llm.generate = self._generate
        model.graph_decoder.generate = self._dit_generate
        model.design_molecule = self._design
        self._hook = model.graph_decoder.denoiser.register_forward_hook(
            self._denoiser_hook)

    def close(self):
        self.model.llm.generate = self._orig_generate
        self.model.graph_decoder.generate = self._orig_dit
        self.model.design_molecule = self._orig_design
        self._hook.remove()

    def reset(self):
        self.batch = -1
        self.calls, self.conds, self.denoised = [], [], []

    def finish(self, pad_id: int):
        """The kept readings on the host; per generate call its served
        tokens by row (what it wrote before its first pad; a row that
        wrote the pad id and then more is None: its tokens cannot be
        read back) and the decode steps it ran."""
        for c in self.calls:
            for k in ("ids", "mask", "out"):
                c[k] = c[k].cpu()
            c["served"], last = [], 0
            for row in c["out"].tolist():
                n = row.index(pad_id) if pad_id in row else len(row)
                c["served"].append(row[:n] if all(v == pad_id for v in
                                                  row[n:]) else None)
                real = [i for i, v in enumerate(row) if v != pad_id]
                last = max(last, real[-1] + 1 if real else 0)
            c["steps"] = 1 + last       # the prefill's pick, then a step
        self.conds = [(b, c.float().cpu()) for b, c in self.conds]

    def _design(self, *args, **kwargs):
        self.batch += 1
        return self._orig_design(*args, **kwargs)

    def _generate(self, input_ids, attention_mask, **kwargs):
        ids, mask = input_ids.detach().clone(), attention_mask.detach().clone()
        out = self._orig_generate(input_ids, attention_mask, **kwargs)
        if self.recording:
            self.calls.append({
                "kind": ("analysis" if kwargs.get("return_decode_state")
                         else "rollback"), "batch": self.batch,
                "ids": ids, "mask": mask, "out": out[0].detach().clone()})
        return out

    def _dit_generate(self, generator, properties, text_emb, rows=None):
        self._step = 0
        if self.recording:
            self.conds.append((self.batch, text_emb.detach().clone()))
        return self._orig_dit(generator, properties, text_emb, rows)

    def _denoiser_hook(self, module, args, output):
        b, step = self.batch, self._step
        self._step += 1
        if (self.recording and 0 <= b < len(self.steps_wanted)
                and step == self.steps_wanted[b]):
            self.denoised.append({
                "batch": b, "step": step,
                "args": [a.detach().clone() if torch.is_tensor(a) else a
                         for a in args],
                "out": [o.detach().clone() for o in output]})


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, control: bool = False) -> core.Run:
    from llamole_tpu_torch.models.composite import GenerationSettings
    from llamole_tpu_torch.serve import DesignServer

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
    requests = gen_traffic.design_requests(seed, tr, data)
    gen = GenerationSettings(max_new_tokens=tr["max_new_tokens"],
                             temperature=tr["temperature"],
                             top_p=tr["top_p"], do_sample=True)
    steps_rng = random.Random(f"denoiser-steps/{seed}")
    n_steps = cfg["graphdit"]["diffusion_steps"]
    capture = Capture(model, [steps_rng.randrange(n_steps)
                              for _ in range(tr["denoiser_checks"])])
    server = DesignServer(model, tok, batch_size=tr["batch_size"],
                          max_wait_s=tr["max_wait_s"], gen=gen,
                          rollback=True, seed=seed)
    server.start()
    t = time.monotonic()
    warm = [server.submit(p, prop) for p, prop in
            requests[:tr["batch_size"]]]
    for h in warm:
        h.result(timeout=tr["answer_timeout_s"])
    setup["warmup_s"] = time.monotonic() - t
    capture.reset()

    spans = tracer = None
    if trace:
        from llamole_tpu_torch.ops.fused_attention import \
            fused_block_attention as kernel_a
        spans = core.Spans(sync=on_card)
        tracer = tracing.UnitTracer(tr["trace"]["skip"], tr["trace"]["units"])
        a_count = {}

        def before(a, k):
            if tracer.seen == tracer.skip:
                a_count["t0"] = kernel_a.launches
                a_count["batch"] = capture.batch + 1
            tracer.begin()

        def after(o, a, k):
            tracer.end()
            if tracer.done and "t1" not in a_count:
                a_count["t1"] = kernel_a.launches

        spans.wrap(model, "design_molecule", "design_batch", before=before,
                   after=after)
        spans.wrap(model.llm, "generate", "llm_generate")
        spans.wrap(model.graph_decoder, "sample", "sampler")
        spans.wrap(model, "design_rollback", "rollback")
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start

    # the window: a closed loop of `clients` requests, kept by this one
    # thread (32 client threads contending for the interpreter lock while
    # each tokenizes its resubmission sometimes missed the server's 0.05 s
    # gather and split a batch): the server answers in submission order,
    # so each answer is taken in that order and its client's next request
    # submitted at once
    n_clients = tr["clients"]
    pool = len(requests)
    records, pending = [], collections.deque()
    t0 = time.monotonic()

    def send(i, k):
        prompt, prop = requests[(i + n_clients * (k + 1)) % pool]
        pending.append((i, k, time.monotonic(), server.submit(prompt, prop)))

    for i in range(n_clients):
        send(i, 0)
    while pending:
        i, k, ts, h = pending.popleft()
        try:
            ok = "error" not in h.result(timeout=tr["answer_timeout_s"])
        except TimeoutError:
            ok = False
        records.append((ts, time.monotonic(), ok))
        if time.monotonic() < t0 + seconds:
            send(i, k + 1)
    server.stop()
    if on_card:
        torch.cuda.synchronize()
    capture.recording = False
    capture.finish(tok.pad_token_id)

    done = [r for r in records if r[2]]
    res.attempted = len(records)
    res.failed = res.attempted - len(done)
    last = max((r[1] for r in records), default=t0 + seconds)
    lat = [r[1] - r[0] if r[2] else float("inf") for r in records]
    res.e2e = {"setup_s": setup_s,
               "design_req_per_min": len(done) * 60.0 / (last - t0),
               "design_latency_p90_s": p_quantile(lat, 0.9) if lat else
               float("inf")}
    res.counters = {"batches": server.batches_run,
                    "requests_served": server.requests_served,
                    "latency_p50_s": p_quantile(lat, 0.5) if lat else None,
                    "window_s": last - t0, "setup_split": setup,
                    "rows_per_batch": [int(c["ids"].shape[0])
                                       for c in capture.calls
                                       if c["kind"] == "analysis"],
                    "rollback_rows": [int(c["ids"].shape[0])
                                      for c in capture.calls
                                      if c["kind"] == "rollback"],
                    "latency_max_s": max(lat) if lat else None}
    res.spans = spans
    if tracer is not None:
        res.trace = tracer.reduce(spans.log)
        if res.trace is not None:
            res.trace["t0"], res.trace["t1"] = tracer.t0, tracer.t1
            res.trace["a_launches"] = a_count["t1"] - a_count["t0"]
            res.trace["batch"] = a_count["batch"]
    res.shapes = shapes_of(capture, cfg, model)
    if on_card:
        res.device = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(dev),
                      "count": 1,
                      "memory_peak_bytes": torch.cuda.max_memory_allocated(
                          dev)}
        if res.trace is not None:
            res.device["busy_s"] = res.trace["busy_s"]
            res.device["window_s"] = res.trace["window_s"]
    if spans is not None:
        spans.unwrap()
    capture.close()
    calls, conds, denoised = capture.calls, capture.conds, capture.denoised
    del capture, server, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.monotonic()
    judge(res, cell, seed, requests, calls, conds, denoised, spec, dev,
          control)
    res.notes["reference_s"] = time.monotonic() - t
    return res


def shapes_of(capture, cfg, model) -> dict:
    """What the FLOP counts and the per-step metrics read: per generate
    call its rows, prompt tokens (real), width and steps; per sampler
    call its rows and reverse steps; the model's sizes."""
    gen = []
    for c in capture.calls:
        gen.append({"kind": c["kind"], "batch": c["batch"],
                    "rows": int(c["ids"].shape[0]),
                    "width": int(c["ids"].shape[1]),
                    "prompt_tokens": [int(v) for v in c["mask"].sum(1)],
                    "steps": c["steps"]})
    llm = program.llm_fields(cfg)
    llm_params = sum(p.numel() for n, p in model.llm.named_parameters()
                     if not n.startswith("embed.") and "lora_" not in n)
    dit = cfg["graphdit"]
    rows = int(capture.conds[0][1].shape[0]) if capture.conds else 0
    return {"generate": gen, "sampler_rows": 2 * rows,   # guidance doubles
            "sampler_batches": [b for b, _ in capture.conds],
            "reverse_steps": dit["diffusion_steps"],
            "llm_params": llm_params, "llm": llm, "graphdit": dit,
            "xdim": model.graph_decoder.cfg.Xdim,
            "query_tokens": 1 + cfg["learned_query_size"]}


# ---------------------------------------------------------------------------
# the comparison with the plain reference
# ---------------------------------------------------------------------------

def judge(res, cell, seed, requests, calls, conds, denoised, spec, dev,
          control=False):
    cfg, tr, lim = cell.config, cell.traffic, cell.limits
    specials = cfg["special_tokens"]
    sid = ref_tokens.special_ids(specials)
    by_ids = {tuple(ref_tokens.encode(p, specials)): p for p, _ in requests}
    nb = cfg["learned_query_size"]
    body = [sid["<design_start>"]] + [sid["<design_body>"]] * nb
    rng = random.Random(f"check-rows/{seed}")

    # the rows to judge: rollback rows, the longest first, then analysis
    # rows drawn from the seed; rows whose served tokens cannot be read
    # back (the pad id served as a token) are left out
    rows, mismatch = [], 0
    analysis = [(ci, r) for ci, c in enumerate(calls) if c["kind"] ==
                "analysis" for r in range(c["ids"].shape[0])
                if c["served"][r] is not None]
    rollback = [(ci, r) for ci, c in enumerate(calls) if c["kind"] ==
                "rollback" for r in range(c["ids"].shape[0])
                if c["served"][r] is not None]
    rollback.sort(key=lambda cr: -int(calls[cr[0]]["mask"][cr[1]].sum()))
    picks = rollback[:tr["check_rollback_rows"]] + rng.sample(
        analysis, min(tr["check_analysis_rows"], len(analysis)))
    for ci, r in picks:
        c = calls[ci]
        got = [int(v) for v, m in zip(c["ids"][r], c["mask"][r]) if m]
        toks = c["served"][r]
        if c["kind"] == "analysis":
            if tuple(got) not in by_ids:
                mismatch += 1
                res.notes.setdefault("mismatched", []).append("analysis")
                continue
            rows.append({"seq": got + toks + body, "prompt": len(got),
                         "served": toks,
                         "body_end": len(got) + len(toks) + 1 + nb,
                         "cond": _cond(conds, c["batch"], r),
                         "analysis": None})
        else:
            # the rollback prompt: the request, its served analysis, the
            # design query and <rollback_start>, as the reference forms it
            match = _analysis_of(calls, c["batch"], got, by_ids, body,
                                 sid["<rollback_start>"])
            if match is None:
                mismatch += 1
                res.notes.setdefault("mismatched", []).append("rollback")
                continue
            a_call, a_row, a_first = match
            rows.append({"seq": got + toks, "prompt": len(got),
                         "served": toks, "body_end": len(got) - 1,
                         "cond": _cond(conds, c["batch"], a_row),
                         "analysis": (a_first,
                                      calls[a_call]["served"][a_row])})
    res.check("prompt_mismatch", mismatch, lim["prompt_mismatch"])
    if not rows:
        res.check("rows_judged", 0, -1)
        return

    w = _llm_weights(cfg, spec, seed, dev)
    dec = Decoder(program.llm_fields(cfg), w, program.lora_scale(cfg))
    conn = _weights(spec, seed, dev, ("connectors",))
    ref = [_reference_row(dec, conn, row, nb) for row in rows]
    _llm_checks(res, lim, rows, ref, [row["cond"] for row in rows], tr)
    del dec, w
    gc.collect()
    torch.cuda.empty_cache() if dev.type == "cuda" else None

    dit_w = _weights(spec, seed, dev, ("graph_decoder",))
    dcfg = dict(cfg["graphdit"])
    worst = 0.0
    for d in denoised:
        X, E, mask, y, txt, t = d["args"][:6]
        with ref_graph.precision(False), torch.no_grad():
            want = ref_graph.denoiser(dit_w, X.float(), E.float(), mask, y,
                                      txt, t, dcfg)
        worst = max(worst, _rel(d["out"], want, mask))
    if not denoised:      # no kept step: nothing of the sampler judged
        res.check("denoiser_steps", 0, -1)
    res.check("denoiser_err", worst, lim["denoiser_err"])
    res.notes["judged"] = {"rows": len(rows), "denoiser_steps": len(denoised),
                           "served_tokens": sum(
                               len(row["served"]) + len(
                                   (row["analysis"] or (0, []))[1])
                               for row in rows)}

    if control:
        w = _llm_weights(cfg, spec, seed, dev)
        dec = Decoder(program.llm_fields(cfg), w, program.lora_scale(cfg),
                      quantize="int8")
        low = [_reference_row(dec, conn, row, nb)["cond"] for row in rows]
        sub = core.Run()
        _llm_checks(sub, lim, rows, ref, low, tr)
        ctrl = {"cond_err": dict((n, v) for n, v, _ in sub.checks)[
            "cond_err"]}
        del dec, w
        gc.collect()
        worst = 0.0
        for d in denoised:
            X, E, mask, y, txt, t = d["args"][:6]
            with torch.no_grad():
                with ref_graph.precision(False):
                    want = ref_graph.denoiser(dit_w, X.float(), E.float(),
                                              mask, y, txt, t, dcfg)
                with ref_graph.precision(True):
                    low_out = ref_graph.denoiser(dit_w, X.float(), E.float(),
                                                 mask, y, txt, t, dcfg)
            worst = max(worst, _rel(low_out, want, mask))
        ctrl["denoiser_err"] = worst
        res.notes["control"] = ctrl


def _cond(conds, batch, row):
    for b, c in conds:
        if b == batch:
            return c[row]
    return None


def _analysis_of(calls, batch, rb_ids, by_ids, body, rb):
    """(call, row, prompt length) of the analysis row whose request,
    served analysis and design query make this rollback prompt."""
    for ci, c in enumerate(calls):
        if c["kind"] != "analysis" or c["batch"] != batch:
            continue
        for r in range(c["ids"].shape[0]):
            prompt = [int(v) for v, m in zip(c["ids"][r], c["mask"][r]) if m]
            toks = c["served"][r]
            if tuple(prompt) not in by_ids or toks is None:
                continue
            if prompt + toks + body + [rb] == rb_ids:
                return ci, r, len(prompt)
    return None


def _weights(spec, seed, dev, prefixes):
    from .. import weights
    return weights.tensors(spec, seed, dev, prefixes)


def _llm_weights(cfg, spec, seed, dev):
    return _weights(spec, seed, dev, ("llm.",))


@torch.no_grad()
def _reference_row(dec, conn, row, nb):
    """The reference's logits at the positions that chose the row's
    served tokens (its decode and, for a rollback row, the analysis
    inside its prompt) and its design condition (the mean of the nb body
    hiddens through the connector)."""
    ids = torch.tensor(row["seq"], device=next(iter(dec.w.values())).device)
    with ref_graph.precision(False):
        hidden = dec.hidden(dec.embed(ids))
        p, n = row["prompt"], len(row["served"])
        out = {"logits": dec.logits(hidden[p - 1:p - 1 + n]).cpu()}
        if row["analysis"] is not None:
            first, a_served = row["analysis"]
            out["a_logits"] = dec.logits(
                hidden[first - 1:first - 1 + len(a_served)]).cpu()
        end = row["body_end"]
        h = hidden[end - nb:end].mean(0)
        out["cond"] = torch.nn.functional.silu(
            h @ conn["connectors.lm_to_graph_decoder.weight"].t()
            + conn["connectors.lm_to_graph_decoder.bias"]).cpu()
    return out


def candidate_floor(logits, tr):
    """The least logit a token may have and still be drawn: the sampler
    keeps, of the logits over the temperature, the top_p_candidates
    largest, and of those the smallest set whose mass (under the whole
    vocabulary's softmax) reaches top_p."""
    z = logits / tr["temperature"]
    vals, _ = torch.topk(z, tr["top_p_candidates"], dim=-1)
    probs = torch.exp(vals - torch.logsumexp(z, dim=-1, keepdim=True))
    keep = (torch.cumsum(probs, -1) - probs) < tr["top_p"]
    keep[:, 0] = True
    last = keep.sum(-1) - 1
    return vals.gather(1, last[:, None])[:, 0] * tr["temperature"]


def _llm_checks(res, lim, rows, ref, conds, tr):
    """sampled_outside: the served tokens (each row's decode and its
    analysis) below the reference's least drawable logit by more than
    the margin; cond_err: the worst relative error of conds (the
    program's design conditions, or a control's) against the
    reference's."""
    cond = 0.0
    outside = 0
    for row, r, c in zip(rows, ref, conds):
        pairs = [(r["logits"], row["served"])]
        if "a_logits" in r:
            pairs.append((r["a_logits"], row["analysis"][1]))
        for logits, served in pairs:
            if not served:
                continue
            tok = torch.tensor(served, dtype=torch.long)
            ref_tok = logits.gather(1, tok[:, None])[:, 0]
            floor = candidate_floor(logits, tr)
            outside += int((ref_tok < floor - lim["sampled_margin"]).sum())
        if c is not None:
            cond = max(cond, float((c - r["cond"]).norm()
                                   / r["cond"].norm().clamp_min(1e-30)))
        else:
            cond = float("inf")
    res.check("sampled_outside", outside, lim["sampled_outside"])
    res.check("cond_err", cond, lim["cond_err"])


def _rel(got, want, mask):
    """The larger relative L2 error of the atom and bond logits over the
    valid nodes and pairs."""
    worst = 0.0
    pair = mask[:, :, None] & mask[:, None, :]
    for g, wv, m in ((got[0], want[0], mask), (got[1], want[1], pair)):
        d = (g.float() - wv)[m]
        worst = max(worst, float(d.norm() / wv[m].norm().clamp_min(1e-30)))
    return worst
