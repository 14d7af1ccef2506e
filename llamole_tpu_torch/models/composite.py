"""GraphLM: the composite multimodal model (counterpart of
llamole_tpu/models/composite.py, generation side).

Phase 1, molecular design:
  1. the LLM (+ LoRA) decodes an analysis with a KV cache
  2. <design_start> + K x <design_body> run as a query extension on that
     cache (no re-forward of prompt + analysis); the mean of the K body
     hiddens is the design hidden
  3. lm_to_graph_decoder connector -> SiLU -> GraphDiT text condition
  4. GraphDiT reverse diffusion (CFG) -> SMILES on the host
  5. failed rows: optional diffusion redraws, then LLM rollback text

Phase 2, retrosynthesis (Retro* from llamole_tpu.planner, JAX-free):
  1. the GraphCLIP embedding of each product (kernel B) passes
     graph_to_lm -> SiLU and replaces the <molecule> slot of its prompt
  2. the LLM decodes an analysis from those embeddings
  3. analysis + <retro_start> + K x <retro_body> is re-forwarded; the body
     mean passes lm_to_graph_predictor -> SiLU and conditions the GIN
     template predictor (kernel B), whose top-k templates are applied on
     the host
  4. nodes are valued by the base LLM's (adapter off) likert last logits
     plus the optional CostMLP

The module holds every sub-model and the three connectors, so a JAX
(frozen, trainable) pair bridges whole (weights.graph_lm_state_dict).
Training is not ported yet (ROADMAP.md).
"""

import time
from dataclasses import dataclass, replace as dc_replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llamole_tpu.chem import canonical_smiles, recanonicalize
from llamole_tpu.chem.featurize import smiles_to_graph
from llamole_tpu.utils.constants import IGNORE_INDEX

from ..ops.nn import init_dense_
from .gllm import LLM, lora_scale
from .graphclip import GraphCLIP
from .graphdit import GraphDiT
from .retro import CostMLP, GraphPredictor

_LIKERT_ANSWERS = (
    "All readily available",
    "Some commercial, some need 1-2 steps",
    "Mix of commercial and multi-step synthesis",
    "Mostly require complex synthesis",
    "All require extensive multi-step synthesis",
)
_LIKERT_COSTS = np.asarray([0.0, 1.0, 2.5, 4.5, 7.0])


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh (dp-sharded) generation is not "
                                  "ported to llamole_tpu_torch yet "
                                  "(ROADMAP.md: parallelism)")


@dataclass
class GenerationSettings:
    max_new_tokens: int = 128
    temperature: float = 0.6
    top_p: float = 0.9
    top_k: int = 0
    do_sample: bool = True
    repetition_penalty: float = 1.0
    # prompt-lookup drafts per step: None or 0 = the per-token loop;
    # > 0 is not ported yet (raises)
    speculative_tokens: Optional[int] = None
    speculative_ngram: int = 2   # read by the speculative loop (not ported)
    # design query extension on the decode cache instead of a full
    # re-forward (off = always re-forward; a parity knob)
    reuse_decode_cache: bool = True
    # failed diffusion assemblies redraw this many times before rollback
    design_resamples: int = 0


class GraphLM(nn.Module):
    def __init__(self, llm: LLM, graph_decoder: GraphDiT,
                 graph_predictor: GraphPredictor, graph_encoder: GraphCLIP,
                 tokenizer, token_id_dict: Dict[str, int], *,
                 num_body_tokens: int = 8, lora_rank: int = 8,
                 lora_alpha: Optional[int] = None,
                 finetuning_type: str = "lora", use_rslora: bool = False,
                 cost_mlp: Optional[CostMLP] = None):
        """cost_mlp: the optional fingerprint value model of the planner
        (read when molecule_cost_weight > 0)."""
        super().__init__()
        if finetuning_type not in ("lora", "freeze", "full"):
            raise ValueError(f"unknown finetuning_type {finetuning_type!r}")
        self.llm = llm
        self.graph_decoder = graph_decoder
        self.graph_predictor = graph_predictor
        self.graph_encoder = graph_encoder
        self.cost_mlp = cost_mlp
        self.tokenizer = tokenizer
        self.token_id_dict = token_id_dict
        self.num_body_tokens = num_body_tokens
        self.finetuning_type = finetuning_type
        self.lora_scale = lora_scale(lora_rank, lora_alpha,
                                     use_rslora=use_rslora)
        if finetuning_type == "lora":
            llm.add_lora(lora_rank, self.lora_scale)
        lm_h = llm.cfg.hidden_size
        meta = torch.device("meta")
        self.connectors = nn.ModuleDict({
            "graph_to_lm": nn.Linear(graph_encoder.hidden_size, lm_h,
                                     device=meta),
            "lm_to_graph_decoder": nn.Linear(
                lm_h, graph_decoder.text_input_size, device=meta),
            "lm_to_graph_predictor": nn.Linear(
                lm_h, graph_predictor.text_input_size, device=meta),
        }).to_empty(device=llm.device)

    @property
    def device(self) -> torch.device:
        return self.llm.device

    def init_trainable(self, generator: torch.Generator) -> None:
        """Random trainable bundle: connectors (xavier, zero bias) and, for
        finetuning_type 'lora', the adapter (A ~ N(0,1)/r, B = 0)."""
        for name in ("graph_to_lm", "lm_to_graph_decoder",
                     "lm_to_graph_predictor"):
            init_dense_(self.connectors[name], generator)
        if self.finetuning_type == "lora":
            self.llm.reset_lora(generator)

    # ------------------------------------------------------------------
    # token helpers (host side)
    # ------------------------------------------------------------------
    def _eos_ids(self) -> Tuple[int, ...]:
        """eos + every added special token stops decoding."""
        ids = [self.tokenizer.eos_token_id]
        ids.extend(self.tokenizer.additional_special_tokens_ids)
        return tuple(dict.fromkeys(int(i) for i in ids))

    def _strip_pads(self, row) -> List[int]:
        pad = self.tokenizer.pad_token_id
        return [int(t) for t in row if int(t) != pad]

    def _left_pad(self, seqs: Sequence[Sequence[int]],
                  bucket: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """Left-pad to a 64-multiple width (ids, mask) int32."""
        pad = self.tokenizer.pad_token_id
        longest = max(max(len(s) for s in seqs), 1)
        width = ((longest + bucket - 1) // bucket) * bucket
        ids = np.full((len(seqs), width), pad, np.int32)
        mask = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            if s:
                ids[i, -len(s):] = s
                mask[i, -len(s):] = 1
        return ids, mask

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    # Phase 1
    # ------------------------------------------------------------------
    def _generate_tokens(self, input_ids, attention_mask, generator,
                         gen: GenerationSettings, eos_ids,
                         want_state: bool = False, inputs_embeds=None):
        outs = self.llm.generate(
            self._tensor(input_ids), self._tensor(attention_mask),
            generator=generator, max_new_tokens=gen.max_new_tokens,
            temperature=gen.temperature, top_p=gen.top_p, top_k=gen.top_k,
            do_sample=gen.do_sample, eos_ids=tuple(eos_ids),
            pad_id=self.tokenizer.pad_token_id,
            repetition_penalty=gen.repetition_penalty,
            spec_tokens=gen.speculative_tokens,
            return_decode_state=want_state,
            # room for <start> + K body tokens: no grow-copy of the cache
            reserve_cache_slots=(1 + self.num_body_tokens) if want_state
            else 0, inputs_embeds=inputs_embeds)
        toks, done = outs[0].cpu().numpy(), outs[1].cpu().numpy()
        return (toks, done, outs[2]) if want_state else (toks, done)

    @torch.no_grad()
    def _splice_molecule_embeds(self, input_ids, mol_atoms, mol_edges,
                                mol_node_mask, mol_valid, mol_rows,
                                mol_cols) -> torch.Tensor:
        """Token embeddings with each valid (row, col) <molecule> slot
        replaced by SiLU(graph_to_lm(GraphCLIP(molecule))). Tensors on the
        model's device: input_ids [B, L]; mol_* one entry per molecule."""
        embeds = self.llm.embed(input_ids)
        mol = self.graph_encoder(mol_atoms, mol_edges, mol_node_mask)
        conn = self.connectors["graph_to_lm"]
        mol = F.silu(conn(mol.to(conn.weight.dtype))).to(embeds.dtype)
        rows, cols = mol_rows.long(), mol_cols.long()
        embeds[rows, cols] = torch.where(mol_valid[:, None], mol,
                                         embeds[rows, cols])
        return embeds

    @torch.no_grad()
    def _body_hidden(self, input_ids, attention_mask) -> torch.Tensor:
        """Re-forward for the mean of the trailing body-token hiddens
        (logits of the last position only: the [B, L, vocab] head output
        is never read)."""
        _, hidden, _ = self.llm(input_ids=input_ids,
                                attention_mask=attention_mask,
                                last_logits_only=True)
        return hidden[:, -self.num_body_tokens:].mean(dim=1)

    @torch.no_grad()
    def _body_hidden_extend(self, cache, kv_valid, ext_ids) -> torch.Tensor:
        """Query extension: forward ONLY the appended query tokens on top
        of the decode cache (whose reserved slots hold them). Equal to
        _body_hidden's re-forward: the valid region per row is exactly
        prompt + analysis, positions continue the rows' true lengths."""
        b, s = ext_ids.shape
        idx = torch.arange(kv_valid.shape[1], device=kv_valid.device)
        write = torch.where(kv_valid, idx[None] + 1, 0).amax(dim=1)   # [B]
        true_len = kv_valid.sum(dim=1)
        kv_valid = kv_valid | ((idx[None] >= write[:, None])
                               & (idx[None] < (write + s)[:, None]))
        positions = true_len[:, None] + torch.arange(s, device=idx.device)
        _, hidden, _ = self.llm(
            input_ids=ext_ids,
            attention_mask=torch.ones_like(ext_ids, dtype=torch.int32),
            positions=positions, kv_cache=cache, cache_index=write,
            kv_valid=kv_valid, last_logits_only=True)
        return hidden[:, -self.num_body_tokens:].mean(dim=1)

    @torch.no_grad()
    def design_molecule(self, input_ids: np.ndarray,
                        attention_mask: np.ndarray,
                        molecule_properties: np.ndarray,
                        gen: GenerationSettings = GenerationSettings(),
                        rollback: bool = False,
                        generator: Optional[torch.Generator] = None,
                        molecule_batch=None):
        """Phase-1 design: analysis decode -> query extension -> GraphDiT.
        input_ids [B, P] left-padded; molecule_properties [B, 10] (NaN or
        NO_LABEL_INDEX = absent). molecule_batch (numpy mol_atoms,
        mol_edges, mol_node_mask, mol_valid, mol_rows, mol_cols) splices
        GraphCLIP embeddings at <molecule> slots of the prompt. Returns
        (analysis_tokens [B, T] numpy, smiles list)."""
        inputs_embeds = None
        if molecule_batch is not None:
            mb = molecule_batch
            inputs_embeds = self._splice_molecule_embeds(
                self._tensor(input_ids), self._tensor(mb["mol_atoms"]),
                self._tensor(mb["mol_edges"], torch.int32),
                self._tensor(mb["mol_node_mask"], torch.bool),
                self._tensor(mb["mol_valid"], torch.bool),
                self._tensor(mb["mol_rows"]), self._tensor(mb["mol_cols"]))
        outs = self._generate_tokens(input_ids, attention_mask, generator,
                                     gen, self._eos_ids(),
                                     want_state=gen.reuse_decode_cache,
                                     inputs_embeds=inputs_embeds)
        analysis = outs[0]
        design_hidden = None
        if gen.reuse_decode_cache:
            ext = np.full((analysis.shape[0], 1 + self.num_body_tokens),
                          self.token_id_dict["<design_body>"], np.int64)
            ext[:, 0] = self.token_id_dict["<design_start>"]
            state = outs[2]
            design_hidden = self._body_hidden_extend(
                state["cache"], state["kv_valid"], self._tensor(ext))
            del state, outs   # free the cache before the diffusion stage
        input_ids = np.asarray(input_ids)
        prompts = [self._strip_pads(r) for r in input_ids]
        analyses = [self._strip_pads(r) for r in analysis]
        smiles = self.design_from_analysis(
            generator, prompts, analyses, molecule_properties, gen=gen,
            rollback=rollback, design_hidden=design_hidden)
        return analysis, smiles

    @torch.no_grad()
    def design_from_analysis(
        self, generator: Optional[torch.Generator],
        prompt_token_lists: Sequence[Sequence[int]],
        analysis_token_lists: Sequence[Sequence[int]],
        molecule_properties: np.ndarray, *,
        gen: GenerationSettings = GenerationSettings(),
        rollback: bool = False, true_b: Optional[int] = None,
        design_hidden: Optional[torch.Tensor] = None,
    ) -> List[Optional[str]]:
        """Post-decode stages: token surgery -> body hidden (re-forward
        unless given) -> connector -> GraphDiT -> redraws -> rollback."""
        ds = self.token_id_dict["<design_start>"]
        body = self.token_id_dict["<design_body>"]
        seqs = [list(p) + list(a) + [ds] + [body] * self.num_body_tokens
                for p, a in zip(prompt_token_lists, analysis_token_lists)]
        if design_hidden is None:
            ids, mask = self._left_pad(seqs)
            design_hidden = self._body_hidden(self._tensor(ids),
                                              self._tensor(mask))
        conn = self.connectors["lm_to_graph_decoder"]
        cond = F.silu(conn(design_hidden.to(conn.weight.dtype))).float()
        props = self._tensor(molecule_properties, torch.float32)
        smiles = self.graph_decoder.generate(generator, props, cond)
        true_b = len(seqs) if true_b is None else true_b
        for _ in range(max(0, gen.design_resamples)):
            if all(s is not None for s in smiles[:true_b]):
                break
            redraw = self.graph_decoder.generate(generator, props, cond)
            smiles = [a if a is not None else b
                      for a, b in zip(smiles, redraw)]
        smiles = smiles[:true_b]
        seqs = seqs[:true_b]
        if rollback and any(s is None for s in smiles):
            smiles = self.design_rollback(generator, seqs, smiles, gen)
        return smiles

    @torch.no_grad()
    def design_rollback(self, generator, design_seqs: Sequence[Sequence[int]],
                        smiles_list: List[Optional[str]],
                        gen: GenerationSettings) -> List[Optional[str]]:
        """Ask the LLM for SMILES between rollback tags for the rows whose
        diffusion sample failed (reference modeling_llamole.py:665-718)."""
        none_idx = [i for i, s in enumerate(smiles_list) if s is None]
        if not none_idx:
            return smiles_list
        rb = self.token_id_dict["<rollback_start>"]
        rb_end = self.token_id_dict["<rollback_end>"]
        ids, mask = self._left_pad([list(design_seqs[i]) + [rb]
                                    for i in none_idx])
        gen2 = dc_replace(gen, max_new_tokens=gen.max_new_tokens * 2)
        # stop on rollback_end or eos only: the SMILES itself is plain text
        toks, _ = self._generate_tokens(
            ids, mask, generator, gen2,
            (self.tokenizer.eos_token_id, rb_end))
        smiles_list = list(smiles_list)
        for row, i in zip(toks, none_idx):
            text = self.tokenizer.decode(self._strip_pads(row),
                                         skip_special_tokens=True).strip()
            if not text:
                smiles_list[i] = None
                continue
            # parseable text joins the canonical space; the rest passes
            # through raw, as the reference takes the decoded string
            canon = canonical_smiles(text)
            smiles_list[i] = canon if canon is not None else text
        return smiles_list

    # ------------------------------------------------------------------
    # Phase 2: one-step retrosynthesis expansion
    # ------------------------------------------------------------------
    @torch.no_grad()
    def one_step_reaction(self, product_smiles: str,
                          design_text: Optional[str] = None,
                          prefix_ids: Optional[Sequence[int]] = None,
                          topk: int = 50,
                          gen: GenerationSettings = GenerationSettings(),
                          generator: Optional[torch.Generator] = None
                          ) -> Dict[str, Any]:
        """Expand one molecule: analysis -> retro query -> predictor ->
        templates (the one-row batched_one_step_reaction)."""
        return self.batched_one_step_reaction(
            [product_smiles], design_text=design_text, prefix_ids=prefix_ids,
            topk=topk, gen=gen, generator=generator)[0]

    @torch.no_grad()
    def batched_one_step_reaction(
        self, product_smiles_list: Sequence[str],
        design_text=None, prefix_ids=None, topk: int = 50,
        gen: GenerationSettings = GenerationSettings(),
        analysis_tokens: Optional[int] = None,
        pad_rows_to: Optional[int] = None,
        generator: Optional[torch.Generator] = None, mesh=None,
    ) -> List[Dict[str, Any]]:
        """Frontier-batched expansion: one analysis decode and one retro
        re-forward for every product. design_text / prefix_ids are one
        value for all rows or one per row. With pad_rows_to the batch is
        padded to that width by repeating the last product (pad rows are
        dropped from the result). Prompts and retro queries left-pad to
        256-token bands; the analysis budget is at least analysis_tokens
        (default 512, the reference's)."""
        _no_mesh(mesh)
        n_real = len(product_smiles_list)
        if n_real == 0:
            return []
        w = max(n_real, pad_rows_to or 0)
        if (design_text is None or isinstance(design_text, str)
                or len(design_text) == 0):
            texts = [design_text if isinstance(design_text, str) else None
                     ] * n_real
        else:
            texts = list(design_text)
        if (prefix_ids is None or len(prefix_ids) == 0
                or not isinstance(prefix_ids[0], (list, tuple))):
            prefixes = [prefix_ids] * n_real
        else:
            prefixes = list(prefix_ids)
        graphs = [smiles_to_graph(s) for s in product_smiles_list]
        prompts = []
        for dt, pre in zip(texts, prefixes):
            text = ((f"{dt} " if dt else "")
                    + "To synthesize <molecule>, follow these procedures: ")
            prompts.append(list(pre or []) + self.tokenizer.encode(text))
        graphs += [graphs[-1]] * (w - n_real)
        prompts += [prompts[-1]] * (w - n_real)
        ids, mask = self._left_pad(prompts, bucket=256)

        # graph bank: one product per row at its (last) <molecule> slot
        mol_id = self.token_id_dict["<molecule>"]
        max_n = max((g.n_nodes for g in graphs if g is not None), default=8)
        n_pad = ((max_n + 7) // 8) * 8
        atoms = np.zeros((w, n_pad), np.int64)
        edges = np.zeros((w, n_pad, n_pad), np.int32)
        gmask = np.zeros((w, n_pad), bool)
        cols = np.zeros(w, np.int64)
        valid = np.zeros(w, bool)
        for i, g in enumerate(graphs):
            if g is None:
                continue
            k = g.n_nodes
            atoms[i, :k] = g.atom_types
            edges[i, :k, :k] = g.edge_classes
            gmask[i, :k] = True
            pos = np.flatnonzero(ids[i] == mol_id)
            if pos.size:
                cols[i] = pos[-1]
                valid[i] = True
        embeds = self._splice_molecule_embeds(
            self._tensor(ids), self._tensor(atoms),
            self._tensor(edges, torch.int32), self._tensor(gmask, torch.bool),
            self._tensor(valid, torch.bool), self._tensor(np.arange(w)),
            self._tensor(cols))

        floor = analysis_tokens or 512
        gen_a = dc_replace(gen, max_new_tokens=(
            max(gen.max_new_tokens, floor) if gen.max_new_tokens else floor))
        analysis, _ = self._generate_tokens(ids, mask, generator, gen_a,
                                            self._eos_ids(),
                                            inputs_embeds=embeds)
        del embeds

        rs = self.token_id_dict["<retro_start>"]
        body = self.token_id_dict["<retro_body>"]
        a_tokens = [self._strip_pads(row) for row in analysis]
        retro_ids, retro_mask = self._left_pad(
            [a + [rs] + [body] * self.num_body_tokens for a in a_tokens],
            bucket=256)
        hidden = self._body_hidden(self._tensor(retro_ids),
                                   self._tensor(retro_mask))
        conn = self.connectors["lm_to_graph_predictor"]
        cond = F.silu(conn(hidden.to(conn.weight.dtype))).float()

        results = []
        for i, (smi, g) in enumerate(zip(product_smiles_list,
                                         graphs[:n_real])):
            if g is None:
                results.append({"reactants": [], "scores": [],
                                "templates": [],
                                "analysis": self.tokenizer.encode(
                                    "Invalid product SMILES")})
                continue
            reactants, scores, templates = \
                self.graph_predictor.sample_templates(g, cond[i], smi, topk)
            results.append({
                "reactants": reactants, "scores": scores,
                "templates": templates,
                "analysis": self.tokenizer.encode(
                    f"To synthesize {smi}, follow these procedures: ")
                + a_tokens[i]})
        return results

    # ------------------------------------------------------------------
    # Phase 2: synthesis-cost estimation (the A* value function)
    # ------------------------------------------------------------------
    _VALUE_CHUNK = 32   # rows per value-scoring forward

    @torch.no_grad()
    def _last_logits(self, input_ids, attention_mask) -> torch.Tensor:
        """Last-position logits of the BASE LLM (the adapter off): the
        reference scores values with the base model."""
        with self.llm.adapter_disabled():
            logits, _, _ = self.llm(input_ids=input_ids,
                                    attention_mask=attention_mask,
                                    last_logits_only=True)
        return logits[:, -1]

    def _answer_logits(self, last: torch.Tensor) -> np.ndarray:
        """[rows, 5] mean logit over each likert answer's tokens (f32)."""
        toks = [self.tokenizer.encode(a) for a in _LIKERT_ANSWERS]
        flat = sorted({t for ts in toks for t in ts})
        sub = last[:, self._tensor(flat)].float().cpu().numpy()
        col = {t: i for i, t in enumerate(flat)}
        return np.stack([sub[:, [col[t] for t in ts]].mean(axis=1)
                         for ts in toks], axis=1)

    def _value_prompt(self, content: str, chat_template) -> List[int]:
        from llamole_tpu.data.template import get_template
        template = chat_template or get_template("default")
        return self.tokenizer.encode(template.render_prompt(
            [{"role": "user", "content": content}]))

    @torch.no_grad()
    def batched_estimate_complexity(self, smiles_list: Sequence[str],
                                    language_cost_weight: float = 1.0,
                                    chat_template=None) -> List[float]:
        """Likert cost scoring of many molecules, _VALUE_CHUNK rows per
        forward, prompts left-padded to 256-token bands."""
        prompts = [self._value_prompt(
            f"Estimate remaining steps for the target {smiles} considering "
            "intermediate complexity, reagent availability, side reactions, "
            "stereochemistry.", chat_template) for smiles in smiles_list]
        rows = []
        for start in range(0, len(prompts), self._VALUE_CHUNK):
            ids, mask = self._left_pad(
                prompts[start:start + self._VALUE_CHUNK], bucket=256)
            rows.append(self._answer_logits(
                self._last_logits(self._tensor(ids), self._tensor(mask))))
        out = []
        for a_logits in (np.concatenate(rows) if rows else []):
            p = np.exp(a_logits - a_logits.max())
            p = p / p.sum()
            out.append(float((p * _LIKERT_COSTS).sum())
                       * language_cost_weight)
        return out

    @torch.no_grad()
    def estimate_synthesis_complexity(
        self, smiles: str, reaction=None, molecule_cost_weight: float = 0.0,
        language_cost_weight: float = 1.0, chat_template=None,
    ) -> float:
        """CostMLP fingerprint cost + the likert scoring of one molecule
        (with the parent reaction's step, template and reactants)."""
        cost = 0.0
        if molecule_cost_weight > 0 and self.cost_mlp is not None:
            try:
                cost += self.cost_mlp.estimate_cost(smiles) \
                    * molecule_cost_weight
            except ValueError:
                pass
        if language_cost_weight > 0:
            if reaction is None:
                content = (f"Estimate remaining steps for the target {smiles} "
                           "considering intermediate complexity, reagent "
                           "availability, side reactions, stereochemistry.")
            else:
                reactants = ", ".join(r.smiles for r in reaction.children)
                content = (f"Estimate remaining steps for the target {smiles} "
                           f"at step {reaction.depth + 1} with template "
                           f"{reaction.template} and reactants {reactants}.")
            ids, mask = self._left_pad(
                [self._value_prompt(content, chat_template)], bucket=256)
            a_logits = [float(v) for v in self._answer_logits(
                self._last_logits(self._tensor(ids), self._tensor(mask)))[0]]
            p = np.exp(a_logits - np.max(a_logits))
            p = p / p.sum()
            cost += float((p * _LIKERT_COSTS).sum()) * language_cost_weight
        return cost

    def _value_fns(self, molecule_cost_weight: float,
                   language_cost_weight: float):
        """(value_fn, batch_value_fn or None) for the planner."""
        use_mlp = molecule_cost_weight > 0 and self.cost_mlp is not None

        def value_fn(s, parent_reaction):
            return self.estimate_synthesis_complexity(
                s, parent_reaction, molecule_cost_weight,
                language_cost_weight)

        def batch_value_fn(smiles_batch):
            if language_cost_weight > 0:
                vals = self.batched_estimate_complexity(
                    smiles_batch, language_cost_weight)
            else:
                vals = [0.0] * len(smiles_batch)
            if use_mlp:
                vals = [v + molecule_cost_weight * c for v, c in zip(
                    vals, self.cost_mlp.estimate_costs(smiles_batch))]
            return vals

        return value_fn, (batch_value_fn if language_cost_weight > 0
                          or use_mlp else None)

    # ------------------------------------------------------------------
    # Phase 2: multi-step retrosynthesis (Retro* search)
    # ------------------------------------------------------------------
    def _starting_mols(self, starting_mols) -> set:
        if starting_mols is None:
            if self.graph_predictor.available is None:
                raise ValueError("No starting molecules available.")
            return set(self.graph_predictor.available)   # canonical
        return {recanonicalize(s) for s in starting_mols}

    @torch.no_grad()
    def retrosynthesize(
        self, smiles: Optional[str], *,
        generator: Optional[torch.Generator] = None, starting_mols=None,
        expansion_topk: int = 50, iterations: int = 100,
        molecule_cost_weight: float = 0.0, language_cost_weight: float = 1.0,
        max_planning_time: float = 300.0, rollback: bool = True,
        design_text: Optional[str] = None,
        prefix_ids: Optional[Sequence[int]] = None,
        gen: GenerationSettings = GenerationSettings(),
        frontier_width: int = 1, mesh=None,
    ) -> Dict[str, Any]:
        """Plan a route for one molecule. frontier_width > 1 expands the W
        best open nodes per iteration in one batch."""
        from llamole_tpu.planner import retro_star_search

        _no_mesh(mesh)
        starting_mols = self._starting_mols(starting_mols)
        if smiles is None:
            return self._failure_result(None)
        target = recanonicalize(smiles.replace("*", "[H]"))
        if not self.graph_decoder.check_valid(target):
            tokens = (self._retro_rollback_tokens(generator, design_text,
                                                  target, gen)
                      if rollback else None)
            return self._failure_result(target, tokens)

        def expand_fn(s):
            return self.one_step_reaction(
                s, design_text=design_text, prefix_ids=prefix_ids,
                topk=expansion_topk, gen=gen, generator=generator)

        def batch_expand_fn(smiles_list):
            return self.batched_one_step_reaction(
                smiles_list, design_text=design_text, prefix_ids=prefix_ids,
                topk=expansion_topk, gen=gen, pad_rows_to=frontier_width,
                generator=generator)

        value_fn, batch_value_fn = self._value_fns(molecule_cost_weight,
                                                   language_cost_weight)
        t0 = time.time()
        success, route, iters = retro_star_search(
            target, starting_mols, expand_fn, value_fn,
            iterations=iterations, max_time=max_planning_time,
            expansion_width=frontier_width,
            batch_expand_fn=batch_expand_fn if frontier_width > 1 else None,
            batch_value_fn=batch_value_fn)
        if success:
            return self._success_result(target, route, iters,
                                        time.time() - t0)
        tokens = (self._retro_rollback_tokens(generator, design_text, target,
                                              gen) if rollback else None)
        return self._failure_result(target, tokens, expansions=iters)

    @torch.no_grad()
    def retrosynthesize_batch(
        self, smiles_list: Sequence[Optional[str]], *,
        generator: Optional[torch.Generator] = None, starting_mols=None,
        expansion_topk: int = 50, iterations: int = 100,
        molecule_cost_weight: float = 0.0, language_cost_weight: float = 1.0,
        max_planning_time: float = 300.0, rollback: bool = True,
        design_text_map: Optional[Dict[str, str]] = None,
        prefix_ids_map: Optional[Dict[str, Sequence[int]]] = None,
        gen: GenerationSettings = GenerationSettings(),
        total_width: int = 8, share_planning_wall: bool = True,
        min_expansions_per_mol: int = 0, overtime_factor: float = 2.0,
        mesh=None,
    ) -> Dict[Optional[str], Dict[str, Any]]:
        """Plan routes for many molecules with one interleaved search
        (planner.retro_star_search_multi): every iteration expands up to
        total_width open nodes across all targets' trees in one batch.

        max_planning_time is the per-molecule wall. share_planning_wall
        (default) runs every tree concurrently under ONE wall of that
        length; False gives the reference's sequential engine budget
        (wall x number of targets). min_expansions_per_mol > 0 lets
        lagging trees run past the shared wall, up to overtime_factor x
        the wall (PARITY.md, known divergence 6). Returns {target: result}
        keyed by the caller's spelling; "time" is the batch wall and
        "expansions" the tree's iterations."""
        from llamole_tpu.planner import retro_star_search_multi

        _no_mesh(mesh)
        starting_mols = self._starting_mols(starting_mols)
        design_text_map = design_text_map or {}
        prefix_ids_map = prefix_ids_map or {}

        out: Dict[Optional[str], Dict[str, Any]] = {}
        key_of: Dict[str, str] = {}      # caller's spelling -> canonical
        targets: List[str] = []
        failed: Dict[str, Dict[str, Any]] = {}
        for smi in smiles_list:
            if smi is None:
                out[None] = self._failure_result(None)
                continue
            if smi in key_of:
                continue
            t = recanonicalize(smi.replace("*", "[H]"))
            key_of[smi] = t
            if t in targets or t in failed:
                continue
            if not self.graph_decoder.check_valid(t):
                tokens = (self._retro_rollback_tokens(
                    generator, design_text_map.get(smi), t, gen)
                    if rollback else None)
                failed[t] = self._failure_result(t, tokens)
                continue
            targets.append(t)
        design_text_map = {key_of.get(k, k): v
                           for k, v in design_text_map.items()}
        prefix_ids_map = {key_of.get(k, k): v
                          for k, v in prefix_ids_map.items()}

        if targets:
            def batch_expand_fn(items):
                # items: [(target, product)]; per-row text and prefix
                # follow the owning target
                return self.batched_one_step_reaction(
                    [s for _, s in items],
                    design_text=[design_text_map.get(t) for t, _ in items],
                    prefix_ids=[list(prefix_ids_map.get(t) or [])
                                for t, _ in items],
                    topk=expansion_topk, gen=gen, pad_rows_to=total_width,
                    generator=generator)

            value_fn, batch_value_fn = self._value_fns(
                molecule_cost_weight, language_cost_weight)
            t0 = time.time()
            wall = (max_planning_time if share_planning_wall
                    else max_planning_time * len(targets))
            searched = retro_star_search_multi(
                targets, starting_mols, batch_expand_fn, value_fn,
                iterations=iterations, max_time=wall,
                total_width=total_width,
                min_iters_per_target=(min_expansions_per_mol
                                      if share_planning_wall else 0),
                max_time_hard=wall * max(overtime_factor, 1.0),
                batch_value_fn=batch_value_fn)
            total_time = time.time() - t0
            for t in targets:
                success, route, iters = searched[t]
                if success:
                    failed[t] = self._success_result(t, route, iters,
                                                     total_time)
                else:
                    tokens = (self._retro_rollback_tokens(
                        generator, design_text_map.get(t), t, gen)
                        if rollback else None)
                    failed[t] = self._failure_result(t, tokens,
                                                     expansions=iters)
        for smi, t in key_of.items():
            out[smi] = failed[t]
        return out

    def _retro_rollback_tokens(self, generator, design_text, smiles,
                               gen: GenerationSettings) -> List[int]:
        """Free-text procedure when planning fails."""
        text = ((f"{design_text} " if design_text else "")
                + f"To synthesize {smiles}, follow these procedures: ")
        ids, mask = self._left_pad([self.tokenizer.encode(text)])
        toks, _ = self._generate_tokens(
            ids, mask, generator, dc_replace(gen, max_new_tokens=256),
            self._eos_ids())
        return self.tokenizer.encode(
            f"To synthesize {smiles}, follow these procedures: ") + \
            self._strip_pads(toks[0])

    @staticmethod
    def _success_result(target, route, iters, total_time) -> Dict[str, Any]:
        reactions, templates, costs, analyses = route.get_reaction_list()
        return {"target": target, "success": True, "time": total_time,
                "reaction_list": reactions, "cost": costs,
                "templates": templates, "analysis_tokens": analyses,
                "route_length": route.length, "expansions": iters}

    @staticmethod
    def _failure_result(target, tokens=None, expansions=0) -> Dict[str, Any]:
        return {
            "target": target, "success": False, "time": 0.0,
            "reaction_list": None, "cost": None, "templates": None,
            "analysis_tokens": tokens if tokens is not None else "<NO ANALYSIS>",
            "route_length": None, "expansions": expansions,
        }

    # ------------------------------------------------------------------
    # full orchestration: design, then retrosynthesis
    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(
        self, input_ids: np.ndarray,
        attention_mask: Optional[np.ndarray] = None,
        molecule_properties: Optional[np.ndarray] = None, *,
        generator: Optional[torch.Generator] = None, rollback: bool = False,
        starting_mols=None, expansion_topk: int = 50, iterations: int = 100,
        molecule_cost_weight: float = 0.0, language_cost_weight: float = 1.0,
        do_molecular_design: bool = True, do_retrosynthesis: bool = True,
        input_smiles_list: Optional[List[Optional[str]]] = None,
        max_planning_time: float = 30.0,
        design_text_list: Optional[List[str]] = None,
        gen: GenerationSettings = GenerationSettings(),
        frontier_width: int = 1, share_planning_wall: bool = True,
        min_expansions_per_mol: int = 0, mesh=None,
    ) -> Dict[str, Any]:
        """Design and / or plan, then the reference's interleaved
        token_lists / text_lists per row."""
        _no_mesh(mesh)
        input_ids = np.asarray(input_ids)
        if attention_mask is None:
            attention_mask = np.ones_like(input_ids)
        info: Dict[str, Any] = {
            "token_lists": [], "text_lists": [],
            "design_analysis_tokens": None, "smiles_list": None,
            "retro_plan_dict": None, "IGNORE_INDEX": IGNORE_INDEX,
        }
        if do_molecular_design:
            analysis, smiles_list = self.design_molecule(
                input_ids, attention_mask, molecule_properties, gen=gen,
                rollback=rollback, generator=generator)
            info["design_analysis_tokens"] = analysis
            info["smiles_list"] = smiles_list
        elif input_smiles_list is not None:
            info["smiles_list"] = [recanonicalize(s) if s is not None
                                   else None for s in input_smiles_list]
        else:
            raise ValueError("Need do_molecular_design or input_smiles_list.")

        def row_text(i):
            return (design_text_list[min(i, len(design_text_list) - 1)]
                    if design_text_list else None)

        def row_prefix(i):
            return self._strip_pads(input_ids[min(i, len(input_ids) - 1)])

        plans: Dict[Optional[str], Dict[str, Any]] = {}
        if not do_retrosynthesis:
            plans = {s: {"success": None} for s in info["smiles_list"]}
        elif (frontier_width > 1 and sum(
                s is not None for s in set(info["smiles_list"])) > 1):
            # one interleaved search spans every molecule's tree
            design_map: Dict[str, str] = {}
            prefix_map: Dict[str, Any] = {}
            for i, smi in enumerate(info["smiles_list"]):
                if smi is None or smi in design_map:
                    continue
                if design_text_list:
                    design_map[smi] = row_text(i)
                prefix_map[smi] = row_prefix(i)
            plans = self.retrosynthesize_batch(
                info["smiles_list"], generator=generator,
                starting_mols=starting_mols, expansion_topk=expansion_topk,
                iterations=iterations,
                molecule_cost_weight=molecule_cost_weight,
                language_cost_weight=language_cost_weight,
                max_planning_time=max_planning_time, rollback=rollback,
                design_text_map=design_map, prefix_ids_map=prefix_map,
                gen=gen, total_width=frontier_width,
                share_planning_wall=share_planning_wall,
                min_expansions_per_mol=min_expansions_per_mol)
        else:
            for i, smi in enumerate(info["smiles_list"]):
                if smi in plans:
                    continue   # duplicate design: reuse the plan
                plans[smi] = self.retrosynthesize(
                    smi, generator=generator, starting_mols=starting_mols,
                    expansion_topk=expansion_topk, iterations=iterations,
                    molecule_cost_weight=molecule_cost_weight,
                    language_cost_weight=language_cost_weight,
                    max_planning_time=max_planning_time, rollback=rollback,
                    design_text=row_text(i), prefix_ids=row_prefix(i),
                    gen=gen, frontier_width=frontier_width)
        info["retro_plan_dict"] = plans

        available = set(self.graph_predictor.available or [])
        decode = lambda toks: self.tokenizer.decode(toks,   # noqa: E731
                                                    skip_special_tokens=True)
        for b, mol in enumerate(info["smiles_list"]):
            token_list: List[int] = []
            text_list: List[str] = []
            if do_molecular_design:
                design_tokens = self._strip_pads(
                    info["design_analysis_tokens"][b])
                token_list = design_tokens + [IGNORE_INDEX]
                text_list = [decode(design_tokens),
                             (mol if mol is not None else "<NO MOLECULE>")
                             + ". "]
            if do_retrosynthesis:
                plan = plans[mol]
                if plan.get("success"):
                    for reaction, template, _, analysis in zip(
                            plan["reaction_list"], plan["templates"],
                            plan["cost"], plan["analysis_tokens"]):
                        a = (list(analysis)
                             if isinstance(analysis, (list, tuple)) else [])
                        token_list.extend(a + [IGNORE_INDEX])
                        text_list.extend([
                            decode(a), reaction or "<NO REACTION>",
                            " with the template ",
                            template or "<NO TEMPLATE>",
                            " which requires the reactants: "])
                        if reaction:
                            reactants = reaction.split(">>")[1].split(".")
                            text_list.extend([", ".join(
                                r + " (available)" if r in available else r
                                for r in reactants), ". "])
                        else:
                            text_list.append("<NO REACTANTS>. ")
                else:
                    a = plan.get("analysis_tokens")
                    a = list(a) if isinstance(a, (list, tuple)) else []
                    token_list.extend(a)
                    text_list.extend([decode(a), " <NO REACTION FOUND>"])
            info["token_lists"].append(token_list)
            info["text_lists"].append(text_list)
        return info
