"""GraphLM: the composite multimodal model, Phase 1 (molecular design).

Counterpart of llamole_tpu/models/composite.py design path:

  1. the LLM (+ LoRA) decodes an analysis with a KV cache
  2. <design_start> + K x <design_body> run as a query extension on that
     cache (no re-forward of prompt + analysis); the mean of the K body
     hiddens is the design hidden
  3. lm_to_graph_decoder connector -> SiLU -> GraphDiT text condition
  4. GraphDiT reverse diffusion (CFG) -> SMILES on the host
  5. failed rows: optional diffusion redraws, then LLM rollback text

The graph encoder, the retro predictor and every Phase-2 (retro) method
are not ported yet; they raise and are listed in ROADMAP.md. The module
holds the LLM, the graph decoder and all three connectors, so a JAX
(frozen, trainable) pair bridges whole (weights.graph_lm_state_dict).
"""

from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llamole_tpu.chem import canonical_smiles

from ..ops.nn import init_dense_
from .gllm import LLM, lora_scale
from .graphdit import GraphDiT

_PHASE2 = ("{} is Phase 2 (retrosynthesis) and not ported to "
           "llamole_tpu_torch yet; see ROADMAP.md")


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
    # design query extension on the decode cache instead of a full
    # re-forward (off = always re-forward; a parity knob)
    reuse_decode_cache: bool = True
    # failed diffusion assemblies redraw this many times before rollback
    design_resamples: int = 0


class GraphLM(nn.Module):
    def __init__(self, llm: LLM, graph_decoder: GraphDiT, tokenizer,
                 token_id_dict: Dict[str, int], *, num_body_tokens: int = 8,
                 lora_rank: int = 8, lora_alpha: Optional[int] = None,
                 finetuning_type: str = "lora", use_rslora: bool = False,
                 graph_encoder_hidden_size: int = 64,
                 graph_predictor_text_size: int = 768):
        """graph_encoder_hidden_size / graph_predictor_text_size size the
        graph_to_lm and lm_to_graph_predictor connectors (the Phase-2
        modules themselves are not ported); the defaults are the JAX
        loader's random-init fallbacks."""
        super().__init__()
        if finetuning_type not in ("lora", "freeze", "full"):
            raise ValueError(f"unknown finetuning_type {finetuning_type!r}")
        self.llm = llm
        self.graph_decoder = graph_decoder
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
            "graph_to_lm": nn.Linear(graph_encoder_hidden_size, lm_h,
                                     device=meta),
            "lm_to_graph_decoder": nn.Linear(
                lm_h, graph_decoder.text_input_size, device=meta),
            "lm_to_graph_predictor": nn.Linear(
                lm_h, graph_predictor_text_size, device=meta),
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
                         want_state: bool = False):
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
            else 0)
        toks, done = outs[0].cpu().numpy(), outs[1].cpu().numpy()
        return (toks, done, outs[2]) if want_state else (toks, done)

    @torch.no_grad()
    def _body_hidden(self, input_ids, attention_mask) -> torch.Tensor:
        """Re-forward for the mean of the trailing body-token hiddens."""
        _, hidden, _ = self.llm(input_ids=input_ids,
                                attention_mask=attention_mask)
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
            kv_valid=kv_valid)
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
        NO_LABEL_INDEX = absent). Returns (analysis_tokens [B, T] numpy,
        smiles list)."""
        if molecule_batch is not None:
            raise NotImplementedError(_PHASE2.format(
                "splicing molecule graphs into the prompt"))
        outs = self._generate_tokens(input_ids, attention_mask, generator,
                                     gen, self._eos_ids(),
                                     want_state=gen.reuse_decode_cache)
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
    # Phase 2: not ported yet
    # ------------------------------------------------------------------
    @property
    def graph_encoder(self):
        raise NotImplementedError(_PHASE2.format("the GraphCLIP encoder"))

    @property
    def graph_predictor(self):
        raise NotImplementedError(_PHASE2.format("the retro predictor"))

    def one_step_reaction(self, *args, **kwargs):
        raise NotImplementedError(_PHASE2.format("one_step_reaction"))

    def retrosynthesize_batch(self, *args, **kwargs):
        raise NotImplementedError(_PHASE2.format("retrosynthesize_batch"))
