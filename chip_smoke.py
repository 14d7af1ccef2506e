#!/usr/bin/env python3
"""Smoke run of llamole_tpu_torch (the PyTorch + CUDA port) on one card.

    python3 chip_smoke.py

1. Needs CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from llamole_tpu_torch/csrc (one nvcc per
   source, in parallel; build seconds and the ptxas report).
3. Kernel A check: the fused graph attention against its plain PyTorch
   version at the main-path shape (16, 50, 1024, 16) and at (5, 17, 128,
   4) and (8, 64, 256, 8), in f32 (tolerance 1e-4, the JAX kernel's
   contract) and bf16 (2e-2 absolute: the output is a convex combination
   of O(1) v rows and bf16 rounds at ~4e-3), on rows whose node is kept.
   At the main shape in bf16 (the tensor-core body) and in f32 (the
   split-TF32 tensor-core body, the route of every GraphDiT loaded from a
   checkpoint): call time (CUDA events), device time (torch.profiler,
   else CUDA-graph replay), the same for the FMA body on the same inputs
   (its error gated too), the plain version's time, the bound (bytes and
   operations from the shape, H100 peaks) and, as a floor for the
   attention part only, F.scaled_dot_product_attention on the
   already-normalised heads (TF32 off, as main() sets it).
4. Kernel B check: the GIN aggregation against its plain version at the
   path shapes (8, 56, 300) and (1, 24, 300) in f32, at (3, 11, 40) and
   (2, 17, 64) in f32 and bf16, at H = 42 and 150 (the scalar lanes) and
   on dense graphs at N = 200 and 512 (past kernel C's limit) in f32 and
   bf16, each on symmetric and directed random graphs; an empty graph
   and a bank of 80 empty graphs (exact zeros); the training bank (80,
   50, 300) f32 with the 8 MOLECULES in the last, then the first rows
   (padding graphs exactly 0); two runs bit-identical. f32 within 1e-4
   (abs and rel, the JAX contract), bf16 within 1e-2 x max|ref| (the
   output rounds once to bf16). Call time (CUDA events), device time
   (torch.profiler), plain time, bound and share at both shapes the main
   path launches it: (8, 56, 300) f32 on molecular graphs (the splice)
   and the training bank (the molecules in the first rows, and times
   again with them in the last rows). Run alone to iterate on the kernel (seconds):
   python3 -c "import chip_smoke as s; from llamole_tpu_torch.ops import
   cuda_lib, gin_aggregate as G; cuda_lib.library(); s.check_gin(
   G.gin_aggregate, G.gin_aggregate_reference, s.card_tag())"
5. Kernel C check: the GIN backward (dx and dtable) against its plain
   version at (2, 9, 24) (the JAX contract), (3, 11, 40) and (3, 11, 42)
   (H not a multiple of 4: the scalar lane path), symmetric and directed
   graphs, f32 and bf16 (same tolerances as B); H = 300 and 150 in f32
   (vector and scalar lanes); dense graphs at the largest N the kernel
   takes in f32 and bf16, and N one past it refused with nothing
   launched; an empty graph and a bank of 80 empty graphs (exact zeros);
   the training path's shape (80, 50, 300) f32 with the 8 MOLECULES in
   the last rows, then in the first rows; two runs bit-identical.
   CUDA-event and profiler device times of kernel and plain version at
   the path shape, and the bound on the bytes the math needs there
   (gin_bytes). Run alone to iterate on the kernel (seconds):
   python3 -c "import chip_smoke as s; from llamole_tpu_torch.ops import
   cuda_lib, gin_aggregate as G; cuda_lib.library(); s.check_gin_backward(
   G.gin_aggregate_backward, G.gin_aggregate_backward_reference,
   s.card_tag())"
6. Kernel D check: the pre-split graph attention against masked_attention
   at the JAX contract shapes (f32, 2e-5) and the denoiser's head shape
   (16, 16, 50, 64) in f32 (1e-4) and bf16 (2e-2, as A); timed there in
   bf16 and in f32 as A is (the routed body and the FMA body), beside its
   bound and the one-call library equivalent
   F.scaled_dot_product_attention with the key mask. Kernel D
   is on no path of the JAX package or of the port: its launches are
   those of this check.
7. Design + retrosynthesis at full width through the serving entry
   point: Llama-3.1-8B shape (random bf16 weights drawn on the card from
   a seed, LoRA rank 8) + GraphDiT 1024 wide, 28 deep, 16 heads, 50
   nodes, 100 diffusion steps, CFG 2.0 + GraphCLIP 5 x 300 + the GIN
   template predictor 5 x 300 (text 768, 16 labels, the built-in
   templates and inventory), f32, behind DesignServer(batch_size=8) with
   the serving retro defaults (top-k 50, 100 iterations, 30 s wall,
   width 8); 11 requests with the llama_drug.yaml generation settings,
   those with i % 3 == 0 asking for a route. Every answer must carry no
   "error", every retro request whose molecule was designed a "retro"
   block; kernel A must have launched >= 28 x steps x design batches, all
   on its tensor-core body, and kernel B >= 5 x (expansion rounds +
   products scored). Every kernel count is set to 0 just before and read
   just after each of phases 7-9. Sampler ms per reverse step printed.
   First, on the slice's LLM: generate's per-token decode replayed as a
   CUDA graph against the eager loop (check_decode_graphs: greedy and
   sampled tokens bit-equal, ms a step each way at batch 8).
8. run_molqa (the eval entry point) on the same model: 2 records of
   data/molqa_drug_examples.json, frontier width 8, one shared 30 s
   planning wall, scores on (FGD through GraphCLIP, kernel B).
9. Training through run_mmsft on the same model with
   config/train/llama_lora.yaml's settings (logging every micro step):
   the 4 training records of data/molqa_train_examples.json, 4 micro
   steps, 2 updates. Every loss finite; the trainable bundle unchanged
   by the first update (lr 0) and the LoRA and all three connectors
   changed by the second; frozen checksums (LLM base, denoiser, bond
   tables) unchanged; kernel C >= 4 x 4 and kernel B >= 10 x 4 launches,
   kernel A none inside the training loss; the log, checkpoint-4 and the
   predictions written (kept for phase 12). Per micro step wall,
   tokens/s and the forward / backward / optimizer split, and the peak
   memory.
10. Reference checks: f32 copies of the full-width denoiser, GraphCLIP and
   the predictor (forward and backward: logits, the condition's and the
   bond tables' gradients) on the card (kernel paths) against the same
   weights on the CPU (plain paths), max relative error < 1e-3.
11. The learned-weights stack (llamole_tpu_torch/train/stack.py's stages)
   after the slice's memory is freed: a synthetic corpus of 128 train and
   4 eval records; pretraining at the reference widths, batch 64, f32
   (STACK_SIZES: GraphDiT 1024 x 28, 16 heads, 100 diffusion steps, 10
   steps; the predictor and GraphCLIP 5 x 300, the oracle 3 x 128 and
   the CostMLP, 20 steps each), every loss finite and the predictor's,
   oracle's and CostMLP's last 5 steps below their first 5; kernels B and
   C >= layers x steps launches in each GIN pretraining and no call of
   their plain versions; each module saved, reloaded through the port's
   loader and its forward bit-identical; the stack's LLM config (256 x
   6, tied embeddings) and run_mmsft with full finetuning for 4 steps
   over the trained modules; run_molqa on the 4 eval records with the
   oracle (64 new tokens, 2 iterations, 10 s walls), its summary carrying
   property_accuracy / property_mae. Per stage: wall, first and last
   loss, peak memory; B and C timed at the pretraining bank (64, n, 300)
   and (64, n, 128) f32, n the largest corpus product rounded up to 8.
12. Weight interchange on the slice's Llama-3.1-8B shape (bf16). Before
   the slice is freed: phase 9's output (adapter.msgpack, the connectors,
   checkpoint-4's trainable.msgpack and opt_state.msgpack) reloads
   bit-identically into the model and a new Trainer; the frozen base is
   exported as an HF checkpoint in 5 GiB shards (timed, GB/s) and the
   graph modules saved with save_pretrained(save_graph_modules=True);
   the phase fails up front if the disk cannot hold what it writes
   (~34 GiB). After phase 11, on an empty card: merge_adapter through its
   normal entry (the base, phase 9's adapter, the graph modules ->
   merged/: safetensors import, merge_lora, model.msgpack, the merged HF
   export; each timed; model.msgpack streams into a byte counter that
   keeps its size and sha256, as the machine's disk takes 45 GiB of
   writes a run: WRITE_BUDGET), the unmerged (base + adapter) and the
   merged export built through build_graph_lm, every merged tensor equal
   to base + adapter bit for bit, the last-token logits within
   MERGE_LOGIT_TOL and the reloaded LLM's msgpack, streamed again, of
   model.msgpack's size and sha256, then 3 requests (64 new tokens, the first with a
   route, 10 s retro wall) served from the merged model: no error, A >=
   28 x reverse steps x design batches, all on the split-TF32 body (the
   reloaded GraphDiT is f32), B >= 5 x (rounds + products);
   peak memory; base/ and merged/ deleted in a finally.
13. Continuous serving (after phase 8, on a slice of its own whose LLM
   is Llama-3.1-8B's width at 8 of its 32 layers, CONTINUOUS_LAYERS):
   see run_continuous.
14. Quantized serving at the slice's Llama-3.1-8B shape, after phase 12
   on an emptied card (QUANTIZED): (a) the LLM drawn straight into int8
   weights with the int8 KV cache (as bench.py's molqa cell builds it),
   the graph modules as in phase 7, 4 of phase 7's requests (the first
   asking for a route) through DesignServer at phase 7's settings: no
   "error", a "retro" block, A >= 28 x steps x design batches all on the
   mma body, B >= 5 x (rounds + products), the LLM's weight bytes below
   0.55x the bf16 LLM's, decode tok/s beside phase 7's, the peak, and
   ms per decode step of its LLM with each cache, adapter on and off,
   with one profiled run (decode_split); (e)
   quantize_denoiser_params on a copy of its GraphDiT: one forward within
   0.05 of bf16, a design batch of 8 at 100 steps on it (validity, A all
   mma), ms per reverse step beside bf16's; (b) a bf16 8B-width LLM
   (24 of 32 layers since phase 16 joined) from a
   seed, rebuilt and quantized in place per scheme (int8, W8A8, int4):
   bytes (< 0.55x, 0.55x, 0.35x), every projection of the first and last
   layers and the head on the bf16 activations within the scheme's bound
   (QUANT_BOUNDS), the batch-8 prefill's last-position logits (relative
   error, top-1 agreement) and ms per greedy decode step over 32 tokens
   beside bf16's, every W8A8 projection through torch._int_mm (counted),
   which is exact at the decode's shapes; (c) on the bf16 LLM, one decode
   step with the int8 KV cache against the compute-dtype cache (logits;
   the first layer's attention output within 0.02) and the greedy
   agreement over 32 tokens; (d) run_mmsft with quantization_bit=8 over
   the loader's int8 base (QLORA_DEVIATIONS): finite losses, the LoRA and
   the connectors changed, the base's checksum unchanged, the peak beside
   phase 9's.
15. The LLM's other families at full width, after phase 14 on an emptied
   card (FAMILIES; bf16, random weights from seed 0, each model freed
   before the next; qwen3 and gemma-3 cut in depth to 4 and 6 layers
   since phase 16 joined): (a) qwen3_8b: 8 prompts, 128
   greedy tokens per-token and with drafts (K=2), on the compute-dtype
   and on the int8 KV cache: tok/s each way, accepted drafts a verify
   step, the guard; the cache against the no-cache forward of prompt +
   tokens (teacher-forced; max |diff| / max |logit| < CACHE_LOGIT_TOL), and
   each row where the drafted tokens part from the per-token ones must
   part where the per-token path's top-2 gap is at most twice that
   check's largest difference; (b) gemma2_9b (softcaps, sandwich norms,
   GeGLU, sliding windows; all 42 layers) serving 4 of phase 7's requests (the first
   asking for a route) through DesignServer over phase 7's graph modules
   at phase 7's settings: no "error", a "retro" block, A >= 28 x steps x
   design batches all mma, B >= 5 x (rounds + products), latencies and
   peak; (c) gemma3_12b on a 1280-token prompt: the cache against the
   forward from slot 1024 on (past the 1024-token window of its sliding
   layers), and 32 greedy steps with drafts off (the auto rule under the
   window); (d) Mixtral at full width (4096 / 14336, 8 experts, top-2),
   8 of 32 layers: the units dropped for capacity at prefill and decode,
   64 greedy tokens per-token and with drafts; at a capacity of 8 (no
   drops) the cache and drafts checks of (a); one GraphLM.loss and
   backward at batch 2 (two training records, the router term in the LM
   loss, finite gradients on the attention LoRA and the connectors; B
   and C counted).
16. The rest of training, after phase 15 on an emptied card (FINETUNE;
   Llama-3.1-8B width, bf16, random weights from seed 0), each part
   through run_mmsft with llama_lora.yaml's settings, 4 micro steps and
   2 updates, over phase 7's graph modules, B >= 10 x 4 and C >= 4 x 4
   in each run and no plain GIN call on the card: (a) DoRA + LoRA+
   (ratio 16) + shift_attn at all 32 layers: finite
   losses, m, the LoRA and the connectors changed and the base checksum
   not, S²-attn in every layer of every training forward and never in
   generation (s2_attention.calls), each micro step and the peak
   beside phase 9's; (b) PiSSA + DoRA through
   the loader at pissa_layers: one SVD timed per projection shape, the
   untrained last-token logits within MERGE_LOGIT_TOL of the unmodified
   base's, the rank-16 export reloaded onto the original base through
   build_graph_lm(load_adapter=True), within MERGE_LOGIT_TOL of the
   trained model with both LLMs widened to f32 (in bf16 the gap is
   reported beside the share of the update DoRA's bf16 weight cast keeps
   in each model); (c) GaLore (rank 16, interval 200, scale 0.25) with
   full finetuning at galore_layers: its moments' bytes against AdamW's,
   the refresh SVD at the embedding's shape, checkpoint-4 reloaded
   bit-identically into a new Trainer; then BAdam (4 blocks, switching
   every update) with full finetuning at badam_layers: only the active
   block's leaves changed at each update.
17. The entry points and tools (ENTRY), inside phase 12 once its merged
   model is freed, over phase 12's files (the 8B base as HF
   safetensors, phase 9's adapter, the graph modules, which load in f32:
   A on its split-TF32 body), kernel counts set to 0 before and read after each
   part, each part timed by the host clock: (a) `python -m llamole_tpu_torch
   env` in a subprocess from the repo root names the card; (b)
   validate_data on data/molqa_train_examples.json reports ok, then
   `pretrain oracle` on it for 20 steps inside profiling.trace(): B and
   C >= 3 layers x 20 steps, no plain GIN call, a Chrome trace naming
   both kernels (its size printed); (c) `eval` on a YAML written with
   utils/flat_yaml (llama_drug.yaml's settings, 64 new tokens, eval batch
   2, over a 2-record copy of data/molqa_drug_examples.json): the results
   JSON with its summary, no record with an "error", A >= 28 x steps x
   design batches, every launch on the split-TF32 body, B >= 5 x (rounds
   + products); (d) `parity` with
   converted/ already holding the graph modules (nothing converts), (b)'s
   oracle, 1 record and a 10 s wall: parity_table.json with the JAX
   package's keys (PARITY_KEYS) and a validity, A and B as in (c); (e)
   DesignUIServer on 127.0.0.1, port 0: the page equal to _render_page(),
   /health, one design with {"HIV": 1.0, "SA": 2.5} (JAX's keys, an SVG
   when valid, A and B as in (c); its wall and latency printed), a
   malformed body answered 500 with an "error", /health after it, and the
   server shut down in a finally.
18. Mesh training (MESH), once phase 12's export has read phase 9's
   model, on that model (Llama-3.1-8B width, 32 layers, rank-8 LoRA):
   run_mmsft with phase 9's settings (its trainable bundle restored to
   phase 9's start, save_steps 2) on a world-size-1 NCCL mesh dp:1,tp:1
   (the LLM's sharded leaves DTensors), (a) at zero stage 1 and (b) at
   zero stage 3 (FSDP2 over the frozen LLM) under LLAMOLE_ORBAX=1, whose
   checkpoint-2 is DCP's async save; then (c) (b) resumed from
   checkpoint-2. Kernel counts set to 0 before (a) and read after (c):
   B >= 10 x 10 and C >= 4 x 10 launches (10 micro steps), and B and C
   on the last batch's retro bank held to their plain versions on the
   CPU (check_predictor). Each micro step's loss beside phase 9's (one
   card shows no collective that splits work: every micro step of (a)
   and (b) must be within MESH["loss_gap"] of phase 9's), (c)'s equal to
   (b)'s steps 3-4; step walls, peaks, the DCP save wall (the call, then
   the wait) and its bytes.
19. Mesh inference and the pipeline (MESH_INFER), after phase 18 on its
   model (Llama-3.1-8B width, 32 layers, phase 18's rank-8 LoRA; the LLM
   copied back into plain tensors, phase 18's placed copy freed), on a
   world-size-1 NCCL mesh dp:1,tp:1: (a) run_molqa's design phase on 2
   records at phase 8's settings without the mesh (the decode graphed),
   then with training_args.mesh (the group started, the LLM's leaves
   DTensors, its decode eager by design); the analysis tokens, the
   responses and the SMILES equal; batched_one_step_reaction on the
   designed molecules (64 analysis tokens, greedy) with and without the
   mesh: reactants, scores and analyses equal; a greedy 8 x 32 decode of
   the placed LLM equal to the plain one's. Kernel counts set to 0 before
   the mesh's run_molqa and read after its expansion: A >= 28 x steps,
   all on the mma body; B >= 5 x (1 splice + the products). (b) One
   forward and backward of pipeline_lm_loss on phase 9's batch with 2
   microbatches (the mesh's pp axis 1) against the plain forward's
   lm_loss, in turns (plain, pipeline, pipeline, plain): within 1e-3,
   the LoRA gradients (one vector) within 1e-2 relative L2, the largest
   leaf's within 5e-2; walls and peaks.
20. Ring attention, MoE expert parallelism and S²-attn under tp
   (PHASE20), each on a world-size-1 process group (NCCL refuses two
   ranks on one card, so the splitting itself is held by the gloo
   tests): (b) inside phase 15 (d), on its Mixtral model (8 of 32
   layers, capacity factor 1.25: units drop), GraphLM.loss and backward
   with the LLM placed (the MoE layers on their MoEMesh) against (d)'s
   mesh-less loss and gradients, B >= 5 and C >= 4 launches; (c) inside
   phase 16 (a), on its model after its run_mmsft, one LongLoRA micro
   step without the mesh and then on the tp mesh, S²-attn in every
   layer; both gated as phase 19 (b) gates its pipeline (the loss within
   1e-3 relative, the gradients within 1e-2 relative L2 as one vector,
   the largest leaf within 5e-2); (a) after phase 16, ring_attention at
   [1, 4096, 32, 128] bf16 with the last 512 keys padded, forward and
   backward in turns with the plain causal attention (output and
   gradient gaps gated by PHASE20); each part's wall and their sum.
21. The mesh placements of ROADMAP.md item 9d (PHASE21), each on a
   world-size-1 process group: (a) inside phase 14 on the int8
   Llama-3.1-8B at full width and depth: run_molqa's design on 2
   records (64 new tokens) with the int8 base placed equal to the
   mesh-less run (analyses, responses, SMILES; A >= 28 x steps, all
   mma), the int4 and W8A8 LLMs of 14 (b) placed with their logits
   within 5e-2 of the largest mesh-less logit, and 14 (d)'s QLoRA
   through run_mmsft at ZeRO-3 (the int8 buffers in dp chunks) with each
   micro step's loss within 1e-3 of 14 (d)'s; peaks. (b) inside phase
   15 (a), qwen3 freeze-tuned with its q / k norms trainable, one LM
   loss and backward placed on tp against the mesh-less one; (c) inside
   phase 15 (b), gemma-2's LoRA GraphLM.loss and backward at ZeRO-3 (its
   tied embedding under FSDP2) against the mesh-less one; (b) and (c)
   gated as phase 20 (b) and (c). Each part's wall and their sum.
22. Kernel E, the LLM's flash route (use_flash; PHASE22), right after
   phase 9 on its model (Llama-3.1-8B at full width and depth, rank-8
   LoRA, bf16): (a) E's forward, dq and dkv kernels against
   flash_attention_reference (output and dq / dk / dv) at (B, S, H, KV,
   D) = (1, 2048, 32, 8, 128), (2, 1024, 32, 8, 128), (1, 1024, 16, 16,
   256), (1, 1024, 16, 8, 256) and (1, 2048, 16, 16, 256) (gemma-7b's
   heads at (d)'s length) in bf16 and (1, 1024, 32, 8, 128) and (1,
   1024, 16, 8, 256) in f32, row 0 left-padded and the last
   right-padded: f32 within 1e-4;
   bf16 each tile of 64 positions of a head within 2 x the plain
   version's gap to the plain version in f32 on the same inputs plus one
   bf16 step of the tile (flash_gate); two backward runs bit-equal at
   the main shape, at the three head_dim-256 shapes and at both f32
   shapes; at (1, 2048, 32, 8,
   128) bf16 the call ms (CUDA events) of the forward and of forward +
   backward, each kernel's device ms from CUDA-graph replay of its
   launcher, the plain version's, F.scaled_dot_product_attention's with
   the segment mask (call ms and, from graph replay, device ms, the
   forward and the backward apart) and, as a floor, causal without
   segments, and the bound of each half (flash_bound); the same but the
   floor at (1, 1024, 16, 16, 256) bf16 (gemma-7b's heads; the backward
   on its wgmma_wide bodies) and at both f32 shapes (every f32 body in
   split TF32, SDPA with TF32 off) (time_flash_wide); (b)
   the LLM's causal-LM loss + backward through
   LLM.forward(train=True) on [1, 2048] seeded tokens, all real, with
   use_flash off and on, in turns: the losses within 5e-2 of the loss,
   the LoRA gradients within 5e-2 (relative L2), walls and peaks, and the
   flash steps' kernel counts set to 0 before and read after: 32 forward
   launches (64 under remat) and 32 of each backward kernel, no plain
   attention call; then GraphLM.loss on the first training record
   collated to [1, 2048] (a right-padded tail), flash on and off, held
   alike; (c) the causal-LM flash step at [1, 4096], all real: its wall
   and peak (the plain attention would save ~103 GB of probabilities
   there); (d) gemma-1 at gemma-7b's published widths (PHASE22
   ["gemma7b"], 3072 wide, 16 heads of 256 with one KV head each, 28
   layers, vocabulary 256000; random weights in a rank-8 LoRA slice of
   its own, built once phase 9's slice is freed after phase 19): (b)'s
   causal-LM pair at [1, 2048] under its gates, 28 launches of each of
   E's kernels (56 forward under remat); then time_flash_wide at the
   step's shape (1, 2048, 16, 16, 256) with every token real, E's
   device time inside the step each kernel's launches x its replay ms;
   the first path through a model that launches E at head_dim 256
   (run_flash_gemma); (e) Llama-3.1-8B at full width and all 32 layers in
   f32 (what both packages build from fp16: true; random f32 weights in
   a rank-8 LoRA slice of its own after (d)): the causal-LM pair at [1,
   1024] (PHASE22 f32_seq, the route's shortest sequence; the plain f32
   step at 2048 would not fit), 32 launches of each of E's kernels (the
   f32 forward, the split-TF32 dq and dkv), no plain attention call, the
   loss within 1e-4 x loss and the LoRA gradients within 1e-3 (relative
   L2) of the plain f32 step's, walls and peaks; then time_flash_wide
   at (1, 1024, 32, 8, 128) f32 unpadded, E inside the step as in (d)
   (run_flash_f32); (f) (d)'s gemma-7b in f32 (what fp16: true builds,
   all 28 layers; a slice of its own after (e)): (e)'s pair and gates at
   [1, f32_seq], 28 launches of each of E's kernels at head_dim 256 in
   f32, then time_flash_wide at (1, 1024, 16, 16, 256) f32 unpadded, E
   inside the step as in (d) (run_flash_f32_gemma). Run alone (about 3
   min on one H100, on a fresh random slice):
   python3 -c "import gc, torch, chip_smoke as s; from
   llamole_tpu_torch.ops import cuda_lib; cuda_lib.library(); torch.
   backends.cuda.matmul.allow_tf32 = False; m, t = s.build_slice(); s.
   run_flash(m, t, s.card_tag()); del m, t; gc.collect(); s.
   run_flash_gemma(s.card_tag()); gc.collect(); torch.cuda.
   empty_cache(); s.run_flash_f32(s.card_tag()); gc.collect(); torch.
   cuda.empty_cache(); s.run_flash_f32_gemma(s.card_tag())"

Prints, before the last line, one {"kernels": [...]} JSON line (per
kernel: launches on the main path, max_abs_err, ms, plain_ms, device_ms,
bound_ms, bound_by, library_ms; for A and D the launches of each body
and the FMA body's times; an A_tf32x3 entry for A's f32 route, the
split-TF32 body: its launches in phase 12's serving and phase 17
(launches_interchange, launches_entry) and its times, bound and share at
the main shape in f32 beside the FMA body's and SDPA's; D's f32 times
under f32_* keys; for B its launches in run_molqa and in
training and its times, bound and share at the training bank under
train_* keys, with the molecules in the last rows under train_last_*;
for B and C their launches in the phase-11 pretrainings and their
times, bound and share at the pretraining bank under pretrain_* keys
(H = 128 under pretrain_oracle_*); for A and B their launches in phase
12's serving under launches_interchange (A per body too); under
launches_quantized, phase 14's: A's in its serving and int8-denoiser
batch (per body too), B's in its serving and QLoRA training, C's in
the latter; under launches_families, phase 15's: A's in the gemma-2
serving (per body too), B's there and in the Mixtral loss, C's in the
latter; under launches_finetune, phase 16's B and C (its four runs); under
launches_entry, phase 17's: A's (per body too), B's and C's; under
launches_mesh, phase 18's B and C; under launches_mesh_inference, phase
19's A (per body too) and B; under launches_moe_ep and launches_s2_tp,
phase 20 (b)'s and (c)'s B and C; under launches_placements, phase 21's:
A's in (a)'s run_molqa on the mesh (per body too), B's and C's in (a)'s
QLoRA at ZeRO-3 and (c)'s gemma-2 step; a flash_attention entry for
kernel E: one forward + backward at (1, 2048, 32, 8, 128) bf16 under the
main keys, each half under fwd_* / bwd_* (device ms per kernel: fwd,
dq, dkv), its launches those of phase 22 (b)'s causal-LM flash step (per
kernel under launches_fwd / _dq / _dkv, (c)'s under long_*), the
bodies per head dim under fwd_body / bwd_body, the head_dim-256 times
under d256 and the f32 ones under f32 / f32_d256, and (d)'s launches
under launches_d256_fwd / _dq / _dkv with its walls, peaks and gaps
under d256_*, E's times at its step's shape under d256_step and E's
device time inside its step (launches x replay ms) under
d256_step_kernel_ms; (e)'s the same under launches_f32_* and f32_*,
(f)'s under launches_f32_d256_* and f32_d256_* (its step's times under
f32_d256_step);
before it, the whole script's wall; the last line is {"ok": true,
"device": {...}}. Any failure exits non-zero.
"""

import contextlib
import copy
import dataclasses
import gc
import hashlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

MAIN_SHAPE = (16, 50, 1024, 16)          # (2 x batch 8 for CFG, N, H, heads)
CHECK_SHAPES = (MAIN_SHAPE, (5, 17, 128, 4), (8, 64, 256, 8))
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CORPUS = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "C1CC1", "c1ccncc1",
          "CC(N)C(=O)O", "COC", "CS", "C=CC=C", "c1cc[nH]c1"]
REQUESTS = 11
# the header every serving request starts with: phase 13's shared prefix
PROMPT_HEADER = "Design a drug-like molecule, request "
PROPERTIES = [{"HIV": 1.0}, {"BBBP": 1.0}, {"SA": 2.5}, None]
MAX_NODES = 50               # GraphDiT's max_n_nodes, the training banks' N
GIN_HIDDEN = 300             # GraphCLIP and predictor width
GIN_LAYERS = 5               # GraphCLIP and predictor depth (5 x 300)
TRAIN_BATCH = 10             # llama_lora.yaml per_device_train_batch_size
GIN_MAIN = (8, 56, GIN_HIDDEN)   # GraphCLIP splice of a width-8 frontier
# run_mmsft's molecule and retro banks (train/workflow.py: max(8, 8 x
# batch) graphs of max_n_nodes), where every training launch of B runs
GIN_TRAIN = (max(8, 8 * TRAIN_BATCH), MAX_NODES, GIN_HIDDEN)
F32, BOTH = (torch.float32,), (torch.float32, torch.bfloat16)
# kernel B: (shape, dtypes, dense) on random graphs, each symmetric and
# directed: the path shapes, two odd ones, H not a multiple of 4 (the
# scalar lanes), and dense graphs with N past kernel C's limit
GIN_CHECKS = ((GIN_MAIN, F32, False), ((1, 24, 300), F32, False),
              ((3, 11, 40), BOTH, False), ((2, 17, 64), BOTH, False),
              ((4, 50, 42), BOTH, False), ((4, 50, 150), F32, False),
              ((2, 200, 300), BOTH, True), ((1, 512, 300), BOTH, True))
MOLECULES = ["CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
             "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CC(=O)Nc1ccc(O)cc1",
             "COc1ccc2[nH]cc(CCN(C)C)c2c1", "O=C(O)c1ccccc1O",
             "CCN(CC)CCNC(=O)c1ccc(N)cc1", "CC12CCC3c4ccc(O)cc4CCC3C1CCC2O"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, launches: int = 50, repeats: int = 21) -> float:
    """Median per-call time of `fn` over repeats of `launches` calls."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, repeats: int = 11) -> float:
    """Per-call time of `fn` replayed from one CUDA graph of `launches`
    calls: no host work between the launches, so it is the device time
    plus the gaps between kernels (an upper bound of the device time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # allocations before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, launches=1, repeats=repeats) / launches


# H100 SXM datasheet peaks (700 W): HBM bytes/s and operations/s by type.
# f32_tensor: f32-accurate products on the tensor cores, three TF32 passes a
# product (split TF32, as kernels A, D and E's f32 bodies take them) at the
# dense TF32 rate, 494.7e12 / 3; the FMA units' 67e12 is slower, so this is
# the least time for the same f32 products
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32_tensor": 494.7e12 / 3,
                  "f32": 67e12}


def roofline(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    arith = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    return (mem, "bytes") if mem >= arith else (arith, "operations")


def attention_bound(b, n, heads, dh, dtype, layernorm):
    """Kernels A and D: q, k, v read once, the key mask (and A's four
    [dh] norm vectors), the output written once; the two matrix products
    on the tensor cores (bf16) or the f32 units, and ~6 f32 operations a
    logit (scale + mask, max, subtract, exp, sum, divide) plus ~8 an
    element of q and k for A's LayerNorm."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * n * heads * dh * size + b * n
    ew = 6 * b * heads * n * n
    if layernorm:
        nbytes += 4 * dh * size
        ew += 8 * 2 * b * n * heads * dh
    mm = 4 * b * heads * n * n * dh
    kind = "bf16_tensor" if dtype == torch.bfloat16 else "f32_tensor"
    return roofline(nbytes, {kind: mm, "f32": ew})


def gin_bytes(args, backward: bool) -> int:
    """The bytes kernel B or C must move on this run's graphs. Row x[b, j]
    is read only where column j of adj has a non-zero (no term reads it
    otherwise), for C row g[b, i] only where row i has one, and the class
    edge[b, i, j] only where adj[b, i, j] is non-zero (the term is 0
    elsewhere); adj and table are read once in full, and every output is
    written once in full (B: out [B, N, H]; C: dx [B, N, H] and dtable
    [5, H])."""
    x, edge, adj, table = args[:4]
    nz = adj != 0
    row = x.shape[-1] * x.element_size()
    nbytes = int(nz.any(dim=1).sum()) * row           # x rows of used columns
    nbytes += int(nz.sum()) * edge.element_size()     # the bonded pairs' classes
    nbytes += sum(t.numel() * t.element_size() for t in (adj, table))
    nbytes += x.numel() * x.element_size()            # out / dx
    if backward:
        nbytes += int(nz.any(dim=2).sum()) * row      # g rows of used rows
        nbytes += table.numel() * table.element_size()    # dtable
    return nbytes


def gin_bound(args, backward: bool):
    """Kernels B and C: gin_bytes, and the work, which depends on the data
    too: ~12 f32 operations (B: add, exact GELU, weighted sum) or ~16 (C:
    add, GELU derivative, two weighted sums) per channel of each pair whose
    adj is non-zero in this run's graphs."""
    x, adj = args[0], args[2]
    pairs = int((adj != 0).sum())
    return roofline(gin_bytes(args, backward),
                    {"f32": pairs * x.shape[-1] * (16 if backward else 12)})


def device_ms(fn, kernel, launches: int = 20, attempts: int = 3):
    """Mean device time per call (ms) of the CUDA kernels whose names hold
    `kernel` (every kernel when it is None), read from a torch.profiler
    trace of `launches` calls. A trace sometimes holds no device events,
    or only some, for kernels launched through ctypes: up to `attempts`
    traces are taken, a named kernel's trace counts only when it holds
    one event per call, and None is returned when none does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CUDA
                  and (kernel is None or kernel in evt.key)]
        total_us = sum(evt.device_time_total for evt in events)
        complete = kernel is None or sum(e.count for e in events) == launches
        if total_us and complete:
            return total_us / launches / 1e3
    return None


def fma_body(kind, args):
    """A call of kernel A's (kind "fused") or D's ("graph") FMA body on
    the same inputs, bypassing the routing: the body every bf16 call took
    before the tensor-core one (launches not counted)."""
    from llamole_tpu_torch.ops.cuda_lib import launch
    from llamole_tpu_torch.ops.fused_attention import kernel_entry
    if kind == "fused":
        qkv, mask, *norms, heads = args
        b, n, three_h = qkv.shape
        out = torch.empty(b, n, three_h // 3, dtype=qkv.dtype, device="cuda")
        ptrs = [t.data_ptr() for t in (qkv, mask, *norms)]
        tail = (b, n, three_h // 3, heads)
    else:
        q, k, v, mask = args
        out = torch.empty_like(q)
        ptrs = [t.data_ptr() for t in (q, k, v, mask)]
        tail = (q.shape[0], q.shape[1], q.shape[2], q.shape[3])
    fn = kernel_entry(kind, "fma", out.dtype)

    def call():
        launch(fn, out.device, f"{kind} fma body", *ptrs, out.data_ptr(),
               *tail)
        return out
    return call


def time_kernel(name, fn, plain, kernel_key, tag):
    """CUDA-event call time, profiler device time (graph replay when the
    trace holds none) and the plain version's call time, printed."""
    ms = cuda_ms(fn)
    plain_ms = cuda_ms(plain)
    replay = graph_ms(fn)
    dev = device_ms(fn, kernel_key)
    if dev is None:
        dev = replay
    print(f"{name}: call {ms:.4f} ms (CUDA events over back-to-back calls),"
          f" device {dev:.4f} ms (torch.profiler, else graph replay), graph "
          f"replay {replay:.4f} ms; plain version {plain_ms:.4f} ms [{tag}]",
          flush=True)
    return {"ms": ms, "device_ms": dev, "graph_ms": replay,
            "plain_ms": plain_ms}


def time_fused(fused, reference, args, err, body, tag):
    """Kernel A at MAIN_SHAPE on `args` through its routed body, the FMA
    body on the same inputs (its error gated too), the plain version,
    SDPA on the normalised heads as a floor for the attention part (the
    port never calls it; A has no one-call equivalent: its LayerNorms come
    first) and the bound. Returns the record of its JSON entry."""
    import torch.nn.functional as F
    from llamole_tpu_torch.ops.nn import layer_norm
    qkv, mask, qs, qb, ks, kb, heads = args
    b, n, three_h = qkv.shape
    dh, dt = three_h // 3 // heads, qkv.dtype
    name = f"fused attention at {MAIN_SHAPE} {dt}"
    rec = time_kernel(f"{name}, {body} body", lambda: fused(*args),
                      lambda: reference(*args),
                      f"attention_{body}_kernel", tag)
    old = fma_body("fused", args)
    fma_err = float(((old().float() - reference(*args).float())
                     * mask[..., None]).abs().max())
    if not fma_err < TOL[dt]:
        fail(f"the FMA body disagrees at {MAIN_SHAPE} {dt}: {fma_err}")
    fma = time_kernel(f"{name}, fma body (max_abs_err {fma_err:.3e})", old,
                      lambda: reference(*args), "attention_fma_kernel", tag)
    q, k, v = (t.contiguous() for t in qkv.reshape(
        b, n, 3, heads, dh).permute(2, 0, 3, 1, 4))
    q, k = layer_norm(q, qs, qb), layer_norm(k, ks, kb)
    key_mask = mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)

    floor = cuda_ms(sdpa)
    floor_dev = device_ms(sdpa, None)
    bound_ms, bound_by = attention_bound(b, n, heads, dh, dt, layernorm=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"{name}: bound {bound_ms * 1e3:.3f} us ({bound_by}); {body} body "
          f"at {100 * bound_ms / rec['device_ms']:.1f}% of it (fma body "
          f"{100 * bound_ms / fma['device_ms']:.1f}%); SDPA on the "
          f"normalised heads (a floor for the attention part, no LayerNorm;"
          f" torch.backends.cuda.matmul.allow_tf32={tf32}) {floor:.4f} ms a"
          f" call, device {floor_dev} ms [{tag}]", flush=True)
    return {"max_abs_err": err, **rec, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "share": bound_ms / rec["device_ms"],
            "sdpa_floor_ms": floor, "sdpa_floor_device_ms": floor_dev,
            "sdpa_allow_tf32": tf32, "fma_ms": fma["ms"],
            "fma_device_ms": fma["device_ms"], "fma_max_abs_err": fma_err}


def check_kernel(fused, reference, tag):
    """Phase 3 (kernel A). Returns the records of its JSON entries: at
    the main shape in bf16 (the tensor-core body) and in f32 (the
    split-TF32 body), each with the FMA body's times on the same inputs
    and SDPA on the normalised heads as a floor for the attention part."""
    from llamole_tpu_torch.ops.fused_attention import attention_body
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = {}
    for (b, n, h, heads) in CHECK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            dh = h // heads
            qkv = torch.randn(b, n, 3 * h, device="cuda", generator=gen).to(dt)
            mask = torch.rand(b, n, device="cuda", generator=gen) > 0.3
            mask[:, 0] = True        # every graph keeps >= 1 node
            norms = [torch.randn(dh, device="cuda", generator=gen).to(dt)
                     for _ in range(4)]
            out = fused(qkv, mask, *norms, heads)
            torch.cuda.synchronize()
            ref = reference(qkv, mask, *norms, heads)
            if out.shape != ref.shape or not torch.isfinite(out).all():
                fail(f"kernel output {tuple(out.shape)} not finite/shaped")
            err = ((out.float() - ref.float()) * mask[..., None]).abs().max()
            err = float(err)
            print(f"kernel check B,N,H,heads={b},{n},{h},{heads} {dt} "
                  f"({attention_body(n, dh, dt)} body): max_abs_err="
                  f"{err:.3e} (tol {TOL[dt]:g})", flush=True)
            if not err < TOL[dt]:
                fail(f"fused attention disagrees: {err} >= {TOL[dt]}")
            if (b, n, h, heads) == MAIN_SHAPE:
                main[dt] = ((qkv, mask, *norms, heads), err)
    return tuple(time_fused(fused, reference, *main[dt], body, tag)
                 for dt, body in ((torch.bfloat16, "mma"),
                                  (torch.float32, "tf32x3")))


def molecular_graphs(n_pad: int, device="cuda"):
    """MOLECULES as a dense padded batch (atoms, int32 edges, mask) on
    `device`."""
    from llamole_tpu_torch.chem.featurize import (pad_graph_batch,
                                                  smiles_to_graph)
    bank = pad_graph_batch([smiles_to_graph(s) for s in MOLECULES], n_pad)
    return (torch.as_tensor(bank["atom_types"], device=device),
            torch.as_tensor(bank["edge_classes"], device=device),
            torch.as_tensor(bank["node_mask"], device=device))


def check_gin(gin, reference, tag):
    """Phase 4. Returns the record of kernel B's JSON line: the error at
    GIN_MAIN in f32, the times, bound and share at GIN_MAIN on molecular
    graphs and, under train_* keys, at GIN_TRAIN on the training bank
    with the molecules in the first rows (train_last_*: the last rows)."""
    gen = torch.Generator(device="cuda").manual_seed(2)

    def compare(args, dt, what):
        """f32 within atol = rtol = 1e-4 (the JAX contract), bf16 within
        1e-2 x max|ref| (the output rounds once to bf16)."""
        with torch.no_grad():
            out = gin(*args)
        torch.cuda.synchronize()
        ref = reference(*args)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail(f"gin kernel output {tuple(out.shape)} not finite/shaped")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        if dt == torch.float32:
            ok = bool((diff <= 1e-4 + 1e-4 * ref.float().abs()).all())
            tol = "atol = rtol = 1e-4"
        else:
            scale = float(ref.float().abs().max())
            ok = err <= 1e-2 * scale
            tol = f"1e-2 x max|ref| = {1e-2 * scale:.3e}"
        print(f"gin check {what}: max_abs_err={err:.3e} ({tol})", flush=True)
        if not ok:
            fail(f"gin_aggregate disagrees at {what}: {err}")
        return out, err

    main_err = None
    for (b, n, h), dtypes, dense in GIN_CHECKS:
        for dt in dtypes:
            for sym in (True, False):
                args = random_graphs(gen, b, n, h, dt, sym, dense)
                _, err = compare(args, dt, (
                    f"B,N,H={b},{n},{h} {dt} "
                    f"{'symmetric' if sym else 'directed'}"
                    f"{', dense' if dense else ''}"))
                if (b, n, h) == GIN_MAIN and sym:
                    main_err = err
    for (b, n, h) in ((1, 4, 8), GIN_TRAIN):   # no bond anywhere
        none = torch.zeros(b, n, n, device="cuda")
        out = gin(torch.randn(b, n, h, device="cuda", generator=gen),
                  none.to(torch.int32), none,
                  torch.ones(5, h, device="cuda"))
        torch.cuda.synchronize()
        if out.any():
            fail(f"gin_aggregate of {b} empty graphs is not 0")
        print(f"gin check {b} empty graphs, N={n}, H={h}: exactly 0",
              flush=True)

    # the training bank: MOLECULES in the last, then the first rows
    b, n, h = GIN_TRAIN
    x = torch.randn(b, n, h, device="cuda", generator=gen)
    table = torch.randn(5, h, device="cuda", generator=gen)
    banks = {}
    for last in (True, False):
        _, edge, mask, adj = path_graphs(b, n, last)
        args = (x, edge, adj, table)
        out, train_err = compare(args, torch.float32, (
            f"training bank B,N,H={b},{n},{h} f32, {len(MOLECULES)} "
            f"molecules in the {'last' if last else 'first'} rows"))
        if out[mask.logical_not().all(dim=1)].any():
            fail("gin_aggregate wrote non-zeros into a padding graph")
        banks[last] = args
    with torch.no_grad():
        if not torch.equal(gin(*args), gin(*args)):
            fail("gin_aggregate is not bit-identical across runs")
    print("gin check: two runs bit-identical", flush=True)

    def timed(args, what):
        """Call, device and plain times, the bound and the share."""
        shape = tuple(args[0].shape)
        with torch.no_grad():
            rec = time_kernel(f"gin_aggregate at {shape} f32, {what}",
                              lambda: gin(*args), lambda: reference(*args),
                              "gin_aggregate_kernel", tag)
        bound_ms, bound_by = gin_bound(args, backward=False)
        share = bound_ms / rec["device_ms"]
        print(f"gin_aggregate bound at {shape} {bound_ms * 1e3:.3f} us "
              f"({bound_by}), {100 * share:.1f}% of it [{tag}]", flush=True)
        return {**rec, "bound_ms": bound_ms, "bound_by": bound_by,
                "share": share, "shape": list(shape)}

    train, train_last = (
        timed(banks[last], f"the training bank ({len(MOLECULES)} molecules "
                           f"in the {'last' if last else 'first'} rows)")
        for last in (False, True))
    # molecular graphs (~2-3 bonds per atom), as the splice sees them
    b, n, h = GIN_MAIN
    _, edge, mask = molecular_graphs(n)
    adj = ((edge > 0) & mask[:, :, None] & mask[:, None, :]).float()
    x = torch.randn(b, n, h, device="cuda", generator=gen)
    table = torch.randn(5, h, device="cuda", generator=gen)
    serve = timed((x, edge.to(torch.int32).contiguous(), adj, table),
                  "molecular graphs")
    return {"max_abs_err": main_err, **serve, "library_ms": None,
            "train_max_abs_err": train_err,
            **{f"train_{k}": v for k, v in train.items()},
            **{f"train_last_{k}": train_last[k]
               for k in ("ms", "device_ms", "graph_ms", "share")}}


def build_slice(llm=None):
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.graphclip import GraphCLIPConfig
    from llamole_tpu_torch.models.graphdit import (
        GraphDiTConfig, build_data_info_from_smiles)
    from llamole_tpu_torch.models.retro import GraphPredictorConfig
    from llamole_tpu_torch.models.loader import (build_graph_lm_from_configs,
                                                 offline_tokenizer)
    from llamole_tpu_torch.ops.nn import xavier_uniform_

    tok = offline_tokenizer()
    info = build_data_info_from_smiles(CORPUS, max_n_nodes=MAX_NODES)
    dit = GraphDiTConfig(hidden_size=1024, depth=28, num_heads=16,
                         diffusion_steps=100, text_dim=768, guide_scale=2.0)
    model = build_graph_lm_from_configs(
        LLMConfig.llama3_8b(), dit, info, tok, device="cuda", llm=llm,
        llm_dtype=torch.bfloat16, graph_dtype=torch.bfloat16, seed=0,
        finetuning_type="lora", lora_rank=8,
        clip_cfg=GraphCLIPConfig(num_layer=GIN_LAYERS,
                                 hidden_size=GIN_HIDDEN),
        predictor_cfg=GraphPredictorConfig(num_layer=GIN_LAYERS,
                                           hidden_size=GIN_HIDDEN, out_dim=16,
                                           text_input_size=768))
    # the JAX init zero-gates every AdaLN block of the denoiser and of
    # the predictor (training starts from identity blocks); random
    # serving weights redraw those layers so each block's attention and
    # each GIN layer reach the outputs
    gen = torch.Generator(device="cuda").manual_seed(1)
    den = model.graph_decoder.denoiser
    for lin in [blk.ada_fc1 for blk in den.blocks] + [
            den.output_layer.ada_fc2] + list(model.graph_predictor.adapters):
        xavier_uniform_(lin.weight, gen)
    return model, tok


def _sync_card():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(obj, name, log, sync=_sync_card):
    """Wrap obj.name so every call is timed between calls of sync (a
    synchronization of the card by default); log gets (seconds, result)
    per call."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        log.append((time.perf_counter() - t0, out))
        return out

    setattr(obj, name, wrapper)


class PathTimers:
    """Timed wrappers around the stages of design and retrosynthesis.
    With `synced` (the default) each call is timed between
    synchronizations of the card; phase 13 turns it off, so that the
    timers add no wait to its threads (calls are still counted, their
    seconds are then host dispatch times)."""

    def __init__(self, model):
        self.synced = True
        self.log = {k: [] for k in (
            "design", "decode", "sampler", "rounds", "splice", "retro_query",
            "predictor", "value", "retro")}
        for obj, name, key in (
                (model, "design_molecule", "design"),
                (model.llm, "generate", "decode"),
                (model.graph_decoder, "generate", "sampler"),
                (model, "batched_one_step_reaction", "rounds"),
                (model, "_splice_molecule_embeds", "splice"),
                (model, "_body_hidden", "retro_query"),
                (model.graph_predictor, "sample_templates", "predictor"),
                (model, "batched_estimate_complexity", "value"),
                (model, "retrosynthesize_batch", "retro")):
            timed(obj, name, self.log[key], self._sync)

    def _sync(self):
        if self.synced:
            _sync_card()

    def clear(self):
        for calls in self.log.values():
            calls.clear()

    def seconds(self, key):
        return sum(t for t, _ in self.log[key])

    def count(self, key):
        return len(self.log[key])

    def gin_floor(self):
        """Kernel B launches the retro path must have made: one GraphCLIP
        call per expansion round and one predictor call per product
        scored, GIN_LAYERS launches each."""
        return GIN_LAYERS * (self.count("splice") + self.count("predictor"))

    def report_phase2(self, tag):
        rounds = self.seconds("rounds")
        splice = self.seconds("splice")
        query = self.seconds("retro_query")
        pred = self.seconds("predictor")
        decode = rounds - splice - query - pred
        value = self.seconds("value")
        plans = [p for _, out in self.log["retro"] for p in out.values()]
        found = sum(bool(p.get("success")) for p in plans)
        exp = [p.get("expansions", 0) for p in plans]
        print(f"phase 2: {self.count('retro')} searches over {len(plans)} "
              f"molecules, {self.count('rounds')} expansion rounds "
              f"(walls {[round(t, 3) for t, _ in self.log['rounds']]} s), "
              f"expansions per molecule {exp}, routes found {found} "
              f"[{tag}]")
        clock = "" if self.synced else " (host clock, calls not synced)"
        print(f"phase 2 split{clock}: expansion decode {decode:.3f} s, splice "
              f"(GraphCLIP) {splice:.3f} s over {self.count('splice')} calls,"
              f" retro query re-forward {query:.3f} s, predictor + template "
              f"application {pred:.3f} s over {self.count('predictor')} "
              f"products, value scoring {value:.3f} s over "
              f"{self.count('value')} calls; searches "
              f"{self.seconds('retro'):.3f} s [{tag}]", flush=True)


def reset_counts(*wrappers):
    """Every launch count of these kernel wrappers to 0."""
    for w in wrappers:
        for key in ("launches", "launches_mma", "launches_tf32x3",
                    "launches_fma", "launches_smem", "launches_global"):
            if hasattr(w, key):
                setattr(w, key, 0)


def check_one_body(fused, body, what):
    """Every main-path launch of kernel A went through `body`: "mma" for
    a bf16 GraphDiT, "tf32x3" for an f32 one (every GraphDiT loaded from
    a checkpoint); none through the FMA body."""
    print(f"fused_block_attention bodies ({what}): mma "
          f"{fused.launches_mma}, tf32x3 {fused.launches_tf32x3}, fma "
          f"{fused.launches_fma}", flush=True)
    if getattr(fused, f"launches_{body}") != fused.launches:
        fail(f"{what}: {fused.launches} kernel-A launches, "
             f"{getattr(fused, f'launches_{body}')} on the {body} body "
             f"(fma {fused.launches_fma})")


def check_launches(name, launches, need, how):
    print(f"{name} launches {launches} (need >= {need} = {how})", flush=True)
    if launches < need:
        fail(f"{name}: the path launched the kernel {launches} < {need} "
             "times")


def diffusion_steps(model) -> int:
    from llamole_tpu_torch.models.graphdit.api import time_grid
    cfg = model.graph_decoder.cfg
    return len(time_grid(cfg.diffusion_steps, cfg.sampling_steps)) - 1


def run_serving(model, tok, timers, kernels, tag):
    """Phase 7. Returns the launch counts of kernels A (total, mma body,
    fma body) and B in the main-path run, and the latencies of the retro
    and the design-only requests."""
    fused, gin = kernels[:2]
    from llamole_tpu_torch.models.composite import GenerationSettings
    from llamole_tpu_torch.serve import DesignServer

    gen = GenerationSettings(max_new_tokens=128, temperature=0.6, top_p=0.9,
                             do_sample=True)
    server = DesignServer(model, tok, batch_size=8, max_wait_s=0.5, gen=gen,
                          rollback=True, seed=0)
    wants_retro = [i % 3 == 0 for i in range(REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    timers.clear()
    reset_counts(*kernels)
    server.start()
    try:
        handles = [server.submit(f"{PROMPT_HEADER}{i}.",
                                 PROPERTIES[i % len(PROPERTIES)],
                                 retro=wants_retro[i])
                   for i in range(REQUESTS)]
        results = [h.result(timeout=900) for h in handles]
    finally:
        server.stop()
    launches = {"A": fused.launches, "A_mma": fused.launches_mma,
                "A_tf32x3": fused.launches_tf32x3,
                "A_fma": fused.launches_fma, "B": gin.launches}
    check_one_body(fused, "mma", "serving")
    peak = torch.cuda.max_memory_allocated()

    errors = [r["error"] for r in results if "error" in r]
    if len(results) != REQUESTS or errors:
        fail(f"{len(results)} answers, errors: {errors[:3]}")
    for r, retro in zip(results, wants_retro):
        if not isinstance(r["text"], str) or not (
                r["smiles"] is None or isinstance(r["smiles"], str)):
            fail(f"malformed result {r}")
        if retro and r["smiles"] is not None and not isinstance(
                r.get("retro"), dict):
            fail(f"retro request without a retro block: {r}")
    design_batches = timers.count("design")
    print(f"serving: {len(results)} answered ({sum(wants_retro)} asked for "
          f"a route), {server.batches_run} batches", flush=True)
    check_launches("fused_block_attention", launches["A"],
                   model.graph_decoder.cfg.depth * diffusion_steps(model)
                   * design_batches,
                   f"{model.graph_decoder.cfg.depth} x "
                   f"{diffusion_steps(model)} x {design_batches}")
    check_launches("gin_aggregate", launches["B"], timers.gin_floor(),
                   f"{GIN_LAYERS} x ({timers.count('splice')} rounds + "
                   f"{timers.count('predictor')} products)")

    pad = tok.pad_token_id
    decodes = timers.log["decode"]
    dec_tokens = sum(int((out[0] != pad).sum()) for _, out in decodes)
    dec_s = timers.seconds("decode")
    valid = sum(model.graph_decoder.check_valid(r["smiles"])
                for r in results)
    for i, (t, _) in enumerate(timers.log["design"]):
        print(f"design batch {i}: wall {t:.3f} s [{tag}]")
    print(f"decode: {dec_tokens} tokens in {dec_s:.3f} s over {len(decodes)} "
          f"generate calls = {dec_tokens / dec_s:.1f} tok/s [{tag}]")
    steps = diffusion_steps(model)
    calls = [t for t, _ in timers.log["sampler"]]
    print(f"sampler: {len(calls)} calls, {sum(calls):.3f} s total, per call "
          f"{[round(t, 3) for t in calls]}; ms per reverse step "
          f"{[round(1e3 * t / steps, 2) for t in calls]} ({steps} steps a "
          f"call) [{tag}]")
    timers.report_phase2(tag)
    retro_lat = [r["latency_s"] for r, w in zip(results, wants_retro) if w]
    design_lat = [r["latency_s"] for r, w in zip(results, wants_retro)
                  if not w]
    print(f"latency: retro requests {retro_lat} s, design-only requests "
          f"{design_lat} s; routes in answers "
          f"{sum(bool(r.get('retro', {}).get('success')) for r in results)}"
          f" [{tag}]")
    print(f"valid SMILES: {valid} of {len(results)}; peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) [{tag}]",
          flush=True)
    return launches, {"retro": retro_lat, "design": design_lat,
                      "decode_tok_s": dec_tokens / dec_s}


def run_eval(model, tok, timers, kernels, tag):
    """Phase 8: run_molqa over 2 records with the prebuilt model. Returns
    the launches of kernels A and B in it."""
    fused, gin = kernels[:2]
    from llamole_tpu_torch.eval.workflow import run_molqa

    data_dir = Path(__file__).resolve().parent / "data"
    with tempfile.TemporaryDirectory() as out_dir:
        args = dict(
            model_args=SimpleNamespace(adapter_name_or_path=None,
                                       property_oracle_path=None),
            data_args=SimpleNamespace(dataset="molqa_drug_examples",
                                      dataset_dir=str(data_dir),
                                      template="llama3", cutoff_len=128),
            training_args=SimpleNamespace(per_device_eval_batch_size=2,
                                          output_dir=out_dir, seed=0,
                                          mesh=""),
            finetuning_args=SimpleNamespace(),
            generating_args=SimpleNamespace(
                max_new_tokens=128, temperature=0.6, top_p=0.9,
                do_sample=True, repetition_penalty=1.0,
                speculative_tokens=None, speculative_ngram=2,
                frontier_width=8))
        timers.clear()
        reset_counts(*kernels)
        t0 = time.perf_counter()
        results = run_molqa(**args, max_records=2, prebuilt=(model, tok),
                            share_planning_wall=True, score=True)
        wall = time.perf_counter() - t0
        with open(Path(out_dir) / "molqa_results.json") as f:
            summary = json.load(f)["summary"]
    launches = fused.launches, gin.launches
    check_one_body(fused, "mma", "run_molqa")
    if len(results) != 2 or summary["num_records"] != 2:
        fail(f"run_molqa answered {len(results)} records")
    for r in results:
        if "llm_reactions" not in r or not isinstance(r["llm_response"], str):
            fail(f"malformed run_molqa result {r}")
    if summary["fgd"] is not None and not np.isfinite(summary["fgd"]):
        fail(f"FGD not finite: {summary['fgd']}")
    print(f"run_molqa: {wall:.3f} s, summary {json.dumps(summary)} [{tag}]")
    timers.report_phase2(tag)
    check_launches("fused_block_attention (run_molqa)", launches[0],
                   model.graph_decoder.cfg.depth * diffusion_steps(model),
                   f"{model.graph_decoder.cfg.depth} x "
                   f"{diffusion_steps(model)} x 1 design batch")
    check_launches("gin_aggregate (run_molqa)", launches[1],
                   timers.gin_floor() + GIN_LAYERS,
                   f"{GIN_LAYERS} x ({timers.count('splice')} rounds + "
                   f"{timers.count('predictor')} products + 1 FGD chunk)")
    return launches


# Phase 13, continuous serving behind the TCP transport: the pool and the
# design group at phase 7's batch of 8, phase 7's generation settings and
# retro defaults
CONTINUOUS = {"slots": 8, "design_batch": 8, "chunk_steps": 8,
              "cache_len": 1024, "max_new_tokens": 128,
              "retro_iterations": 100, "retro_max_time": 30.0}
# its LLM's depth: Llama-3.1-8B's width cut to 8 of its 32 layers, on a
# slice of its own, to keep the script within its time limit once phase 15
# runs (with phase 13 at full depth the whole script took 1017-1169 s on
# an H100 80GB HBM3 at 700 W)
CONTINUOUS_LAYERS = 8


def _percentiles(values):
    """(p50, p95) of a list, as _LatencyStats picks them (None if empty)."""
    if not values:
        return None, None
    lat = sorted(values)
    return tuple(lat[min(int(q * len(lat)), len(lat) - 1)]
                 for q in (0.50, 0.95))


def _tcp_client(address, lines, timeout=900):
    """Send JSONL lines on one connection; its answers by id."""
    import socket

    with socket.create_connection(address, timeout=timeout) as sock:
        f = sock.makefile("rw", encoding="utf-8")
        for line in lines:
            f.write(line + "\n")
        f.flush()
        answers = [json.loads(f.readline()) for _ in lines]
        f.write("\n")   # the end of this connection's stream
        f.flush()
    return {a["id"]: a for a in answers}


def _pool_step_split(steps_log, busy):
    """Wall and scheduler-thread CPU ms per pool decode step over all
    scheduler steps, and split by what ran beside each on the workers (a
    retro search, else a design group, else nothing), a step counted
    where its midpoint falls."""
    def within(t, spans):
        return any(c["t0"] <= t <= c["t1"] for c in spans)

    split = {k: [0.0, 0.0, 0] for k in (
        "all", "alone", "beside a design group", "beside a retro search")}
    for c in steps_log:
        mid = (c["t0"] + c["t1"]) / 2
        where = ("beside a retro search"
                 if within(mid, busy["retrosynthesize_batch"])
                 else "beside a design group"
                 if within(mid, busy["design_from_analysis"]) else "alone")
        for key in ("all", where):
            split[key][0] += c["t1"] - c["t0"]
            split[key][1] += c["cpu"]
            split[key][2] += c["steps"]
    return ", ".join(f"{k} {1e3 * s / n:.2f} ms per pool step (thread CPU "
                     f"{1e3 * cpu / n:.2f} ms) over {n}"
                     for k, (s, cpu, n) in split.items() if n)


def _must_expand(model, smiles_list) -> bool:
    """Whether a retro group holds a target its search has to expand: a
    valid molecule that is not in the stock (retrosynthesize_batch's own
    tests, which answer the others without a round)."""
    from llamole_tpu_torch.chem import recanonicalize
    stock = model._starting_mols(None)
    for smi in smiles_list:
        if smi is None:
            continue
        t = recanonicalize(smi.replace("*", "[H]"))
        if model.graph_decoder.check_valid(t) and t not in stock:
            return True
    return False


def run_continuous(model, tok, timers, kernels, tag, sizes=None,
                   phase7=None):
    """Phase 13: ContinuousDesignServer behind make_tcp_server on
    127.0.0.1 (a free port), phase 7's 11 requests sent over two TCP
    connections, then one {"stats": true} line. Returns the launches of
    kernels A (per body) and B (none on the CPU, where the test of this
    phase runs it at small sizes)."""
    import threading

    from llamole_tpu_torch.models.composite import GenerationSettings
    from llamole_tpu_torch.serve import (ContinuousDesignServer,
                                         make_tcp_server)

    sizes = sizes or CONTINUOUS
    on_card = model.device.type == "cuda"
    gen = GenerationSettings(max_new_tokens=sizes["max_new_tokens"],
                             temperature=0.6, top_p=0.9, do_sample=True)
    server = ContinuousDesignServer(
        model, tok, slots=sizes["slots"], design_batch=sizes["design_batch"],
        chunk_steps=sizes["chunk_steps"], cache_len=sizes["cache_len"],
        max_wait_s=0.5, gen=gen, rollback=True, seed=0,
        shared_prefix_text=PROMPT_HEADER,
        retro_iterations=sizes["retro_iterations"],
        retro_max_time=sizes["retro_max_time"])
    decoder = server.decoder
    # host-clock intervals with the calling thread's CPU time (a thread
    # waiting for the interpreter lock uses none; one waiting for the card
    # spins): each scheduler step (it ends reading the stop flags, which
    # waits for the card) with the pool decode steps it ran, and each
    # design group and retro search on the workers, with its first
    # argument
    steps_log, busy = [], {"design_from_analysis": [],
                           "design_rollback": [],
                           "retrosynthesize_batch": []}

    def interval(fn, log):
        def call(*args, **kwargs):
            t0, c0 = time.perf_counter(), time.thread_time()
            n0 = decoder.steps_run
            try:
                return fn(*args, **kwargs)
            finally:
                log.append({"t0": t0, "t1": time.perf_counter(),
                            "cpu": time.thread_time() - c0,
                            "steps": decoder.steps_run - n0,
                            "arg": args[0] if args else None})
        return call

    decoder.step = interval(decoder.step, steps_log)
    stages = {name: getattr(model, name) for name in busy}
    for name, fn in stages.items():
        setattr(model, name, interval(fn, busy[name]))
    wants_retro = [i % 3 == 0 for i in range(REQUESTS)]
    lines = [json.dumps({"prompt": f"{PROMPT_HEADER}{i}.",
                         "property": PROPERTIES[i % len(PROPERTIES)],
                         "retro": wants_retro[i]}) for i in range(REQUESTS)]
    # requests 0, 2, 4, ... on connection 0, the rest on connection 1
    conns = [list(range(0, REQUESTS, 2)), list(range(1, REQUESTS, 2))]
    timers.clear()
    timers.synced = False   # no card-wide waits added to the threads
    reset_counts(*kernels)
    answers = {}
    t0 = time.perf_counter()
    server.start()
    tcp = make_tcp_server(server, "127.0.0.1", 0)
    serving = threading.Thread(target=tcp.serve_forever, daemon=True)
    serving.start()
    try:
        def client(k):
            got = _tcp_client(tcp.server_address, [lines[i] for i in conns[k]])
            for n, i in enumerate(conns[k]):
                answers[i] = got.get(n)

        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(len(conns))]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        idle = decoder.idle and len(decoder._free) == decoder.slots
        stats = _tcp_client(tcp.server_address, ['{"stats": true}'])[0]
    finally:
        tcp.shutdown()
        tcp.server_close()
        server.stop()
        timers.synced = True
        for name, fn in stages.items():
            setattr(model, name, fn)
    results = [answers.get(i) for i in range(REQUESTS)]
    errors = [r and r.get("error") for r in results if not r or "error" in r]
    if errors:
        fail(f"continuous serving: {sum(r is not None for r in results)} "
             f"answers, errors {errors[:3]}")
    for r, retro in zip(results, wants_retro):
        if retro and r["smiles"] is not None and not isinstance(
                r.get("retro"), dict):
            fail(f"continuous retro request without a retro block: {r}")
    if stats["requests_served"] != REQUESTS:
        fail(f"continuous serving: stats {stats}")
    if not decoder.prefix_admissions:
        fail("continuous serving: no admission on the shared-prefix path")
    if not idle:
        fail(f"continuous serving: the decoder is not idle after the last "
             f"answer (free slots {decoder._free})")
    # a search that raised or never expanded leaves B's floor at 0: every
    # retro group holding a target to expand must have run a round
    searches = busy["retrosynthesize_batch"]
    expanding = sum(_must_expand(model, c["arg"]) for c in searches)
    if timers.count("retro") != len(searches) or \
            timers.count("rounds") < expanding:
        fail(f"continuous serving: {len(searches)} retro groups, "
             f"{timers.count('retro')} returned, {expanding} with a target "
             f"to expand, {timers.count('rounds')} expansion rounds")
    retro_lat = [r["latency_s"] for r, w in zip(results, wants_retro) if w]
    design_lat = [r["latency_s"] for r, w in zip(results, wants_retro)
                  if not w]
    steps = decoder.steps_run
    valid = sum(model.graph_decoder.check_valid(r["smiles"])
                for r in results)
    print(f"continuous serving over TCP: {REQUESTS} answered in {wall:.3f} s"
          f" over {len(conns)} connections, {server.batches_run} design "
          f"groups, {decoder.chunks_run} chunks, {steps} pool decode steps, "
          f"{decoder.prefix_admissions} of {REQUESTS} admissions on the "
          f"shared prefix ({len(tok.encode(PROMPT_HEADER))} tokens); valid "
          f"SMILES {valid} of {REQUESTS}; stats {json.dumps(stats)} [{tag}]",
          flush=True)
    if steps:
        print(f"continuous decode: {_pool_step_split(steps_log, busy)}; "
              f"{decoder.slots} slots, admissions included [{tag}]",
              flush=True)
    for name, calls in busy.items():
        print(f"continuous {name}: walls "
              f"{[round(c['t1'] - c['t0'], 3) for c in calls]} s, thread CPU"
              f" {[round(c['cpu'], 3) for c in calls]} s [{tag}]",
              flush=True)
    for what, lat in (("design-only", design_lat), ("retro", retro_lat)):
        p50, p95 = _percentiles(lat)
        line = f"latency {what}: p50 {p50} s, p95 {p95} s (continuous)"
        if phase7:
            q50, q95 = _percentiles(phase7["design" if what == "design-only"
                                           else "retro"])
            line += f"; phase 7 (DesignServer) p50 {q50} s, p95 {q95} s"
        print(line + f" [{tag}]", flush=True)
    timers.report_phase2(tag)
    launches = {"A": 0, "B": 0}
    if on_card:
        fused, gin = kernels[:2]
        launches = {"A": fused.launches, "A_mma": fused.launches_mma,
                    "A_fma": fused.launches_fma, "B": gin.launches}
        check_one_body(fused, "mma", "continuous serving")
        depth = model.graph_decoder.cfg.depth
        check_launches("fused_block_attention (continuous)", launches["A"],
                       depth * diffusion_steps(model) * server.batches_run,
                       f"{depth} x {diffusion_steps(model)} x "
                       f"{server.batches_run} design groups")
        check_launches("gin_aggregate (continuous)", launches["B"],
                       timers.gin_floor(),
                       f"{GIN_LAYERS} x ({timers.count('splice')} rounds + "
                       f"{timers.count('predictor')} products)")
    return launches


def check_denoiser(model, tag):
    """Phase 10: full-width denoiser, f32 on the card vs the CPU."""
    den = model.graph_decoder.denoiser
    cfg = model.graph_decoder.cfg
    gpu32 = copy.deepcopy(den).float()
    cpu32 = copy.deepcopy(den).float().cpu()
    rng = np.random.default_rng(0)
    b, n = 2, cfg.max_n_nodes
    X = np.eye(cfg.Xdim, dtype=np.float32)[rng.integers(0, cfg.Xdim, (b, n))]
    E = np.eye(cfg.Edim, dtype=np.float32)[rng.integers(0, cfg.Edim,
                                                        (b, n, n))]
    mask = np.arange(n)[None, :] < np.array([[9], [23]])
    y = rng.normal(size=(b, cfg.ydim)).astype(np.float32)
    y[:, ::2] = np.nan
    txt = rng.normal(size=(b, cfg.text_dim)).astype(np.float32)
    t = np.array([0.5, 0.9], np.float32)
    inputs = [torch.from_numpy(a) for a in (X, E, mask, y, txt, t)]
    with torch.no_grad():
        lx_g, le_g = gpu32(*[a.cuda() for a in inputs])
        lx_c, le_c = cpu32(*inputs)
    for g, c in ((lx_g, lx_c), (le_g, le_c)):
        if g.shape != c.shape or not torch.isfinite(g).all():
            fail("denoiser logits not finite / wrong shape")
        rel = float((g.cpu() - c).abs().max() / c.abs().max())
        print(f"denoiser f32 card vs CPU {tuple(g.shape)}: max rel err "
              f"{rel:.3e} (tol 1e-3) [{tag}]", flush=True)
        if not rel < 1e-3:
            fail(f"full-width denoiser disagrees with the CPU: {rel}")


def check_graphclip(model, tag):
    """Phase 10: full-width GraphCLIP, f32 on the card vs the CPU."""
    enc = model.graph_encoder
    cpu = copy.deepcopy(enc).cpu()
    atoms, edges, mask = molecular_graphs(56)
    with torch.no_grad():
        g = enc(atoms, edges, mask)
        c = cpu(atoms.cpu(), edges.cpu(), mask.cpu())
    if g.shape != c.shape or not torch.isfinite(g).all():
        fail("GraphCLIP embeddings not finite / wrong shape")
    rel = float((g.cpu() - c).abs().max() / c.abs().max())
    print(f"GraphCLIP {enc.cfg.num_layer} x {enc.hidden_size} f32 card vs "
          f"CPU {tuple(g.shape)}: max rel err {rel:.3e} (tol 1e-3) [{tag}]",
          flush=True)
    if not rel < 1e-3:
        fail(f"full-width GraphCLIP disagrees with the CPU: {rel}")


# kernel C: the JAX contract shape, an odd one and one whose H is not a
# multiple of 4 (the scalar lane path), each in f32 and bf16; channel
# widths on the vector and the scalar path in f32; and the training path's
# predictor batch (GIN_TRAIN)
GIN_BWD_CHECKS = ((2, 9, 24), (3, 11, 40), (3, 11, 42))
GIN_BWD_WIDTHS = ((4, 50, 300), (4, 50, 150))
# kernel C's second body (N > 161): one past the staged body, the bank a
# 162-atom molecule gives (pretrain._bucket rounds up to 8) and kernel B's
# largest dense check
GIN_BWD_LARGE_N = (162, 168, 512)
BWD_COUNTS = ("launches", "launches_smem", "launches_global")
# kernel D: the JAX contract shapes (tests/test_pallas.py) and the
# denoiser's head shape
ATTN_CONTRACT = ((2, 4, 13, 24), (1, 2, 64, 64), (3, 8, 50, 32))
ATTN_MAIN = (16, 16, 50, 64)


def random_graphs(gen, b, n, h, dt, symmetric=True, dense=False):
    """x, int32 edges (symmetric like molecules unless asked), adj on the
    valid pairs of a random node count per graph (every node with dense),
    a [5, H] table."""
    x = torch.randn(b, n, h, device="cuda", generator=gen).to(dt)
    edge = torch.randint(0, 5, (b, n, n), device="cuda", generator=gen)
    if symmetric:
        edge = edge.triu(1)
        edge = edge + edge.transpose(1, 2)
    count = torch.randint(1, n + 1, (b, 1), device="cuda", generator=gen)
    valid = torch.arange(n, device="cuda")[None] < (n if dense else count)
    adj = ((edge > 0) & valid[:, :, None] & valid[:, None, :]).to(dt)
    table = torch.randn(5, h, device="cuda", generator=gen).to(dt)
    return x, edge.to(torch.int32).contiguous(), adj, table


def path_graphs(rows: int, n: int, last: bool = False, device="cuda"):
    """MOLECULES in the first rows of a [rows, n] bank (the last rows with
    `last`), the rest empty (padding rows), as the training path's banks
    hold them: (atoms, int32 edges, node mask, f32 adj)."""
    atoms, edges, mask = molecular_graphs(n, device)
    k = atoms.shape[0]
    a = torch.zeros(rows, n, dtype=atoms.dtype, device=device)
    e = torch.zeros(rows, n, n, dtype=torch.int32, device=device)
    m = torch.zeros(rows, n, dtype=torch.bool, device=device)
    at = slice(rows - k, rows) if last else slice(0, k)
    a[at], e[at], m[at] = atoms, edges.to(torch.int32), mask
    adj = ((e > 0) & m[:, :, None] & m[:, None, :]).float()
    return a, e.contiguous(), m, adj


def second_body_at(bwd, args, what, tag, timing=True):
    """Kernel C's second body on a bank whose N the wrapper routes to the
    staged body, launched past the routing (launches not counted): it must
    give the staged body's bits (the bodies differ only in where a pair's
    value and class are read). With `timing`, its call and device times
    under second_body_* keys."""
    from llamole_tpu_torch.ops.gin_aggregate import _launch_backward

    def fn():
        return _launch_backward(*args, "global")
    if not all(torch.equal(u, v) for u, v in zip(fn(), bwd(*args))):
        fail(f"kernel C's second body differs from the staged body at {what}")
    if not timing:
        print(f"gin backward {what}: the second body gives the staged "
              "body's bits", flush=True)
        return {}
    ms = cuda_ms(fn)
    dev = device_ms(fn, "gin_backward_kernel") or graph_ms(fn)
    print(f"gin_aggregate_backward's second body at {what}: the staged "
          f"body's bits; call {ms:.4f} ms, device {dev:.4f} ms [{tag}]",
          flush=True)
    return {"second_body_ms": ms, "second_body_device_ms": dev}


def check_gin_backward(bwd, reference, tag):
    """Phase 5: kernel C against its plain version. Returns the record of
    its JSON line (error, times and bound at the path shape)."""
    from llamole_tpu_torch.ops.gin_aggregate import (GIN_BWD_SMEM_MAX_NODES,
                                                     gin_backward_body)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def compare(args, dt, what, dtable_of_range=False):
        """f32: the JAX contract, atol = rtol = 1e-4 elementwise (dtable
        within 1e-4 of its range with dtable_of_range: on dense graphs an
        entry sums thousands of terms and f32 reordering error grows with
        the sum); bf16: 1e-2 x max|ref| (f32 sums rounded once)."""
        dx, dt_ = bwd(*args)
        torch.cuda.synchronize()
        rdx, rdt = reference(*args)
        errs = []
        for got, ref, name in ((dx, rdx, "dx"), (dt_, rdt, "dtable")):
            if got.shape != ref.shape or not torch.isfinite(got).all():
                fail(f"gin backward {name} not finite / wrong shape")
            diff = (got.float() - ref.float()).abs()
            scale = float(ref.float().abs().max())
            if dt != torch.float32:
                ok = float(diff.max()) <= 1e-2 * scale
            elif dtable_of_range and name == "dtable":
                ok = float(diff.max()) <= 1e-4 * scale
            else:
                ok = bool((diff <= 1e-4 + 1e-4 * ref.float().abs()).all())
            errs.append(float(diff.max()))
            if not ok:
                fail(f"gin_aggregate_backward {name} disagrees at {what}: "
                     f"{float(diff.max())}")
        tol = ("1e-2 x max|ref|" if dt != torch.float32 else
               "atol = rtol = 1e-4" + (", dtable 1e-4 of its range"
                                       if dtable_of_range else ""))
        print(f"gin backward check {what}: max_abs_err dx {errs[0]:.3e}, "
              f"dtable {errs[1]:.3e} ({tol})", flush=True)
        return max(errs)

    def random_case(b, n, h, dt, sym=True, dense=False):
        x, edge, adj, table = random_graphs(gen, b, n, h, dt, sym, dense)
        g = torch.randn(b, n, h, device="cuda", generator=gen).to(dt)
        compare((x, edge, adj, table, g), dt,
                f"B,N,H={b},{n},{h} {dt} "
                f"{'symmetric' if sym else 'directed'}"
                f"{', dense' if dense else ''}", dtable_of_range=dense)
        return x, edge, adj, table, g

    for (b, n, h) in GIN_BWD_CHECKS:
        for dt in (torch.float32, torch.bfloat16):
            for sym in (True, False):
                random_case(b, n, h, dt, sym)
    for (b, n, h) in GIN_BWD_WIDTHS:       # vector and scalar lane paths
        random_case(b, n, h, torch.float32)
    for dt in (torch.float32, torch.bfloat16):  # the staged body's largest N
        args = random_case(2, GIN_BWD_SMEM_MAX_NODES, 64, dt, dense=True)
        second_body_at(bwd, args, f"B,N,H=2,{GIN_BWD_SMEM_MAX_NODES},64 "
                       f"{dt} dense", tag, timing=False)
    # past it, the second body: every launch on the body its N routes to,
    # two runs bit-identical
    for n in GIN_BWD_LARGE_N:
        for dt in (torch.float32, torch.bfloat16):
            x, edge, adj, table = random_graphs(gen, 2, n, 64, dt,
                                                dense=True)
            g = torch.randn(2, n, 64, device="cuda", generator=gen).to(dt)
            args = (x, edge, adj, table, g)
            body = gin_backward_body(n)
            before = {k: getattr(bwd, k) for k in BWD_COUNTS}
            compare(args, dt, f"B,N,H=2,{n},64 {dt} dense, the {body} body",
                    dtable_of_range=True)
            first, second = bwd(*args), bwd(*args)
            if not all(torch.equal(u, v) for u, v in zip(first, second)):
                fail(f"gin_aggregate_backward at N={n} {dt} is not "
                     "bit-identical across runs")
            made = {k: getattr(bwd, k) - before[k] for k in BWD_COUNTS}
            want = {k: 3 if k in ("launches", f"launches_{body}") else 0
                    for k in BWD_COUNTS}
            if made != want:
                fail(f"gin_aggregate_backward at N={n}: launches {made}, "
                     f"not 3 on the {body} body")
            print(f"gin backward N={n} {dt}: two runs bit-identical, 3 "
                  f"launches on the {body} body", flush=True)

    # no bond anywhere, on both bodies
    for (b, n, h) in ((1, 4, 8), GIN_TRAIN, (4, GIN_BWD_LARGE_N[1], 300)):
        none = torch.zeros(b, n, n, device="cuda")
        dx, dtab = bwd(torch.randn(b, n, h, device="cuda", generator=gen),
                       none.to(torch.int32), none,
                       torch.ones(5, h, device="cuda"),
                       torch.ones(b, n, h, device="cuda"))
        torch.cuda.synchronize()
        if not (bool((dx == 0).all()) and bool((dtab == 0).all())):
            fail(f"gin_aggregate_backward of {b} empty graphs is not 0")
        print(f"gin backward check {b} empty graphs, N={n}, H={h}: "
              "exactly 0", flush=True)

    b, n, h = GIN_TRAIN
    x = torch.randn(b, n, h, device="cuda", generator=gen)
    g = torch.randn(b, n, h, device="cuda", generator=gen)
    table = torch.randn(5, h, device="cuda", generator=gen)
    _, edge, _, adj = path_graphs(b, n, last=True)
    compare((x, edge, adj, table, g), torch.float32,
            f"path B,N,H={b},{n},{h} f32, {len(MOLECULES)} molecules in the "
            "last rows")
    _, edge, _, adj = path_graphs(b, n)
    args = (x, edge, adj, table, g)
    main_err = compare(args, torch.float32,
                       f"path B,N,H={b},{n},{h} f32, {len(MOLECULES)} "
                       "molecules")
    first, second = bwd(*args), bwd(*args)
    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        fail("gin_aggregate_backward is not bit-identical across runs")
    print("gin backward: two runs bit-identical", flush=True)
    rec = time_kernel(f"gin_aggregate_backward at {GIN_TRAIN} f32, "
                      "path graphs", lambda: bwd(*args),
                      lambda: reference(*args), "gin_backward_kernel", tag)
    bound_ms, bound_by = gin_bound(args, backward=True)
    print(f"gin_aggregate_backward bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}, the rows the math reads), "
          f"{100 * bound_ms / rec['device_ms']:.1f}% of it [{tag}]",
          flush=True)
    second = second_body_at(bwd, args, f"the training bank {GIN_TRAIN} f32",
                            tag)
    return {"max_abs_err": main_err, **rec, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **second,
            "second_body_share": bound_ms / second["second_body_device_ms"]}


def time_graph(attn, reference, args, err, body, tag):
    """Kernel D at ATTN_MAIN on `args` through its routed body, the FMA
    body on the same inputs, the plain version, its one-call library
    equivalent F.scaled_dot_product_attention with the key mask, and the
    bound. Returns the record of its JSON entry."""
    import torch.nn.functional as F
    q, k, v, mask = args
    name = f"graph_attention at {ATTN_MAIN} {q.dtype}"

    def plain():
        return reference(q, k, v, key_mask=mask)

    rec = time_kernel(f"{name}, {body} body", lambda: attn(*args), plain,
                      f"attention_{body}_kernel", tag)
    old = fma_body("graph", args)
    fma_err = float((old().float() - plain().float()).abs().max())
    if not fma_err < TOL[q.dtype]:
        fail(f"D's FMA body disagrees at {ATTN_MAIN} {q.dtype}: {fma_err}")
    fma = time_kernel(f"{name}, fma body (max_abs_err {fma_err:.3e})", old,
                      plain, "attention_fma_kernel", tag)
    key_mask = mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)

    sdpa_err = float((sdpa().float() - plain().float()).abs().max())
    library_ms = cuda_ms(sdpa)
    library_dev = device_ms(sdpa, None)
    b, h, n, dh = ATTN_MAIN
    bound_ms, bound_by = attention_bound(b, n, h, dh, q.dtype,
                                         layernorm=False)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    print(f"{name}: bound {bound_ms * 1e3:.3f} us ({bound_by}); {body} body "
          f"at {100 * bound_ms / rec['device_ms']:.1f}% of it (fma body "
          f"{100 * bound_ms / fma['device_ms']:.1f}%); "
          f"F.scaled_dot_product_attention with the key mask "
          f"(torch.backends.cuda.matmul.allow_tf32={tf32}): call "
          f"{library_ms:.4f} ms, device {library_dev} ms, max_abs_err "
          f"{sdpa_err:.3e} [{tag}]", flush=True)
    return {"max_abs_err": err, **rec, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / rec["device_ms"],
            "library_ms": library_ms, "library_device_ms": library_dev,
            "library_allow_tf32": tf32, "fma_ms": fma["ms"],
            "fma_device_ms": fma["device_ms"], "fma_max_abs_err": fma_err}


def check_graph_attention(attn, reference, tag):
    """Phase 6: kernel D against masked_attention. Returns the record of
    its JSON line: error, times and bound at ATTN_MAIN in bf16 (the mma
    body) and, under f32_* keys, in f32 (the tf32x3 body), each with the
    FMA body's times and SDPA's as library_ms; the launches of this check
    in all and per body."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    counts = ("launches", "launches_mma", "launches_tf32x3", "launches_fma")
    before = [getattr(attn, c) for c in counts]
    main = {}
    cases = ([(s, torch.float32, 2e-5) for s in ATTN_CONTRACT]
             + [(ATTN_MAIN, torch.float32, 1e-4),
                (ATTN_MAIN, torch.bfloat16, 2e-2)])
    for (b, h, n, dh), dt, tol in cases:
        q, k, v = (torch.randn(b, h, n, dh, device="cuda",
                               generator=gen).to(dt) for _ in range(3))
        mask = torch.rand(b, n, device="cuda", generator=gen) > 0.3
        mask[:, 0] = True
        out = attn(q, k, v, mask)
        torch.cuda.synchronize()
        ref = reference(q, k, v, key_mask=mask)
        if out.shape != ref.shape or not torch.isfinite(out).all():
            fail("graph_attention output not finite / wrong shape")
        err = float((out.float() - ref.float()).abs().max())
        print(f"graph_attention check B,H,N,Dh={b},{h},{n},{dh} {dt}: "
              f"max_abs_err={err:.3e} (tol {tol:g})", flush=True)
        if not err < tol:
            fail(f"graph_attention disagrees: {err} >= {tol}")
        if (b, h, n, dh) == ATTN_MAIN:
            main[dt] = ((q, k, v, mask), err)
    launches = [getattr(attn, c) - was for c, was in zip(counts, before)]
    rec = time_graph(attn, reference, *main[torch.bfloat16], "mma", tag)
    rec32 = time_graph(attn, reference, *main[torch.float32], "tf32x3", tag)
    return {**rec, **{f"f32_{k}": v for k, v in rec32.items()},
            "launches": launches}


def check_predictor(model, tag, bank=None):
    """Phase 10: full-width predictor, f32, forward and backward on the card
    (kernels B and C) against the same weights on the CPU (plain
    versions): logits, the text condition's gradient and the bond tables'
    gradients. bank: (atoms, edges, node mask) to run on (phase 18: a
    training batch's retro bank), else path graphs at GIN_TRAIN."""
    cards = copy.deepcopy(model.graph_predictor)
    cpu = copy.deepcopy(model.graph_predictor).cpu()
    if bank is None:
        atoms, edges, mask, _ = path_graphs(*GIN_TRAIN[:2])
    else:
        atoms, edges, mask = bank
    b = atoms.shape[0]
    w = torch.randn(b, cards.cfg.out_dim,
                    generator=torch.Generator().manual_seed(5))
    c0 = torch.randn(b, cards.text_input_size,
                     generator=torch.Generator().manual_seed(6))
    results = []
    for mod, dev in ((cards, "cuda"), (cpu, "cpu")):
        for conv in mod.convs:
            conv.bond_embedding.requires_grad_(True)
        c = c0.to(dev).requires_grad_(True)
        logits = mod(atoms.to(dev), edges.to(dev), mask.to(dev), c)
        (logits * w.to(dev)).sum().backward()
        results.append((logits.detach().cpu(), c.grad.cpu(),
                        torch.cat([cv.bond_embedding.grad.cpu()
                                   for cv in mod.convs])))
    for name, g, r in zip(("logits", "d condition", "d bond tables"),
                          *results):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"predictor {name} not finite / wrong shape")
        rel = float((g - r).abs().max() / r.abs().max())
        print(f"predictor {cards.cfg.num_layer} x {cards.cfg.hidden_size} "
              f"f32 card vs CPU {name} {tuple(g.shape)}: max rel err "
              f"{rel:.3e} (tol 1e-3) [{tag}]", flush=True)
        if not rel < 1e-3:
            fail(f"full-width predictor {name} disagrees with the CPU: {rel}")


TRAIN_DEVIATIONS = {
    "output_dir": "a temporary directory",
    "dataset_dir": "the checkout's data/, as an absolute path",
    "logging_steps": "1, so that every micro step's loss is logged",
}


def llama_lora_args(out_dir: str):
    """config/train/llama_lora.yaml as the five argument groups (the card
    has no PyYAML; tests/test_torch_train.py holds these to the YAML),
    with the TRAIN_DEVIATIONS."""
    ns = SimpleNamespace
    data_dir = str(Path(__file__).resolve().parent / "data")
    model_args = ns(
        model_name_or_path="meta-llama/Meta-Llama-3.1-8B-Instruct",
        new_special_tokens=("<design_start>,<design_end>,<design_body>,"
                            "<molecule>,<retro_start>,<retro_end>,"
                            "<retro_body>,<rollback_start>,<rollback_end>"),
        graph_decoder_path="saves/graph_decoder",
        graph_encoder_path="saves/graph_encoder",
        graph_predictor_path="saves/graph_predictor",
        graph_lm_connector_path=None)
    data_args = ns(dataset="molqa_train_examples", dataset_dir=data_dir,
                   template="llama3", cutoff_len=2048, learned_query_size=8,
                   val_size=0.1, max_samples=None, train_on_prompt=False)
    training_args = ns(
        output_dir=out_dir, logging_steps=1, save_steps=2000, plot_loss=True,
        overwrite_output_dir=True, per_device_train_batch_size=TRAIN_BATCH,
        gradient_accumulation_steps=2, learning_rate=1e-4,
        num_train_epochs=4.0, lr_scheduler_type="cosine", warmup_ratio=0.1,
        mesh="", per_device_eval_batch_size=6, warmup_steps=0, max_steps=-1,
        weight_decay=0.0, adam_beta1=0.9, adam_beta2=0.999,
        adam_epsilon=1e-8, max_grad_norm=1.0, seed=42, eval_strategy="no",
        eval_steps=None, resume_from_checkpoint=None)
    finetuning_args = ns(finetuning_type="lora", lora_rank=8,
                         loss_weight_lm=1.0, loss_weight_design=1.0,
                         loss_weight_retro=1.0, use_galore=False,
                         use_badam=False, loraplus_lr_ratio=None)
    generating_args = ns(max_new_tokens=128, temperature=0.95, top_p=0.7)
    return model_args, data_args, training_args, finetuning_args, \
        generating_args


def _snapshot(params):
    return {n: p.detach().clone() for n, p in params.items()}


def _checksum(tensors) -> float:
    return float(torch.stack([t.detach().float().sum() for t in tensors])
                 .double().sum())


def run_training(model, tok, kernels, tag, out_dir):
    """Phase 9: run_mmsft at full width with llama_lora.yaml's settings,
    its output (the trained adapter and checkpoint-4) kept in out_dir for
    phase 12. Returns the kernel-B and kernel-C launches of the run, what
    checkpoint-4 saved (capture_checkpoints), the peak, and the micro
    steps' walls, tokens/s and the peak for phase 16."""
    from llamole_tpu_torch.train.workflow import run_mmsft

    fused, gin, gin_bwd = kernels[:3]
    params = model.trainable_parameters()
    start = _snapshot(params)
    frozen = {
        "LLM base weights": [p for n, p in model.llm.named_parameters()
                             if "lora_" not in n],
        "denoiser": list(model.graph_decoder.denoiser.parameters()),
        "GIN bond tables": [c.bond_embedding for c in
                            (*model.graph_encoder.convs,
                             *model.graph_predictor.convs)]}
    sums = {k: _checksum(v) for k, v in frozen.items()}
    # snapshot the trainable bundle at each training loss call, and count
    # kernel-A launches inside them (the eval pass after training runs
    # the sampling path of the denoiser, which does launch it)
    seen, a_in_training, last_batch = [], [0], []
    loss = model.loss

    def watched(batch, generator=None, train=True, noisy=None):
        a0 = fused.launches
        if train:
            seen.append(_snapshot(params))
            last_batch[:] = [batch]
        out = loss(batch, generator, train, noisy)
        if train:
            a_in_training[0] += fused.launches - a0
        return out

    model.loss = watched     # an instance attribute over the method
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    try:
        with capture_checkpoints() as saved:
            args = llama_lora_args(out_dir)
            t0 = time.perf_counter()
            metrics = run_mmsft(*args, prebuilt=(model, tok))
            wall = time.perf_counter() - t0
        out = Path(out_dir)
        with open(out / "trainer_log.jsonl") as f:
            log = [json.loads(line) for line in f]
        written = {name: (out / name).exists() for name in (
            "trainer_log.jsonl", "checkpoint-4/trainer_state.json",
            "checkpoint-4/trainable.msgpack", "checkpoint-4/opt_state.msgpack",
            "adapter.msgpack", "connector/lm_to_graph_decoder.msgpack",
            "generated_predictions.jsonl")}
    finally:
        del model.loss
    launches = {"A": a_in_training[0], "B": gin.launches,
                "C": gin_bwd.launches}
    c_bodies = {k: getattr(gin_bwd, k) for k in BWD_COUNTS}
    peak = torch.cuda.max_memory_allocated()

    missing = [k for k, ok in written.items() if not ok]
    if missing:
        fail(f"run_mmsft did not write {missing}")
    steps = metrics["step_times"]
    if metrics["train_steps"] != 4 or len(steps) != 4 or len(log) != 4:
        fail(f"expected 4 micro steps, got {metrics['train_steps']}")
    for rec in log:
        vals = [rec[k] for k in ("loss", "lm_loss", "design_loss",
                                 "retro_loss", "grad_norm")]
        if not all(np.isfinite(vals)):
            fail(f"non-finite loss in {rec}")
    if len(seen) != 4:
        fail(f"{len(seen)} training loss calls, expected 4")
    # micro step 3 starts after the first update, whose lr is 0
    unchanged = [n for n in params if not torch.equal(seen[2][n], start[n])]
    if unchanged:
        fail(f"the first update (lr 0) changed {unchanged[:3]}")
    groups = {"LoRA": [n for n in params if "lora_" in n]}
    for name in ("graph_to_lm", "lm_to_graph_decoder",
                 "lm_to_graph_predictor"):
        groups[name] = [n for n in params if f"connectors.{name}." in n]
    for g, names in groups.items():
        if not any(not torch.equal(params[n], start[n]) for n in names):
            fail(f"the second update left {g} unchanged")
    for k, v in frozen.items():
        if _checksum(v) != sums[k]:
            fail(f"frozen {k} changed in training")
    print(f"training: trainable bundle unchanged after update 1 (lr 0), "
          f"LoRA and all three connectors changed after update 2; frozen "
          f"checksums {sums} unchanged", flush=True)
    n_gin = GIN_LAYERS
    check_launches("gin_aggregate_backward (training)", launches["C"],
                   (n_gin - 1) * 4, f"{n_gin - 1} predictor layers x 4 "
                   "micro steps")
    check_launches("gin_aggregate (training)", launches["B"], 2 * n_gin * 4,
                   f"({n_gin} GraphCLIP + {n_gin} predictor layers) x 4")
    print(f"fused_block_attention launches inside training loss calls "
          f"{launches['A']} (need 0: the denoiser trains on the plain "
          "attention)", flush=True)
    if launches["A"]:
        fail("kernel A launched inside the training loss")
    for i, (st, rec) in enumerate(zip(steps, log)):
        total = st["forward_s"] + st["backward_s"] + st["optimizer_s"]
        print(f"micro step {i + 1}: {st['tokens']} tokens, wall {total:.3f} s"
              f" = forward {st['forward_s']:.3f} + backward "
              f"{st['backward_s']:.3f} + optimizer {st['optimizer_s']:.3f};"
              f" {st['tokens'] / total:.1f} tok/s; loss {rec['loss']:.4f} "
              f"(lm {rec['lm_loss']:.4f}, design {rec['design_loss']:.4f}, "
              f"retro {rec['retro_loss']:.4f}), lr {rec['learning_rate']:.3g}"
              f" [{tag}]", flush=True)
    print(f"run_mmsft: {wall:.3f} s wall (training "
          f"{metrics['train_runtime']:.3f} s, eval_loss "
          f"{metrics.get('eval_loss')}); peak memory {peak / 2**30:.2f} "
          f"GiB (torch.cuda.max_memory_allocated) [{tag}]", flush=True)
    profile_training_step(model, last_batch[0], tag)
    walls = [st["forward_s"] + st["backward_s"] + st["optimizer_s"]
             for st in steps]
    phase9 = {"peak": f"{peak / 2**30:.2f} GiB", "step_s": walls,
              "tok_s": [st["tokens"] / w for st, w in zip(steps, walls)],
              "losses": [rec["loss"] for rec in log], "start": start,
              "final": _snapshot(params), "batch": last_batch[0]}
    return launches["B"], c_bodies, saved, phase9["peak"], phase9


# phase 18: mesh training on one card. loss_gap / bundle_gap: how far a
# micro step's loss and the trained bundle after update 2 may be from
# phase 9's. A world-size-1 mesh runs the same arithmetic in the same
# order (its losses equal phase 9's bit for bit on the H100), so the
# bounds only leave room for nondeterministic kernels; update 2 moves an
# element by up to about the peak learning rate, 1e-4, so a wrong tp or
# ZeRO-1 gradient or update shows in the bundle far above bundle_gap.
MESH = {"mesh": "dp:1,tp:1", "save_steps": 2, "loss_gap": 1e-3,
        "bundle_gap": 1e-6}


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def _snapshot_local(model):
    """The trainable bundle's local tensors (whole on a world-size-1
    mesh), in f32."""
    from llamole_tpu_torch.train.optimizers import local_data
    return {n: local_data(p).detach().float().clone()
            for n, p in model.trainable_parameters().items()}


def run_mesh_training(model, tok, kernels, tag, work, phase9):
    """Phase 18 (module docstring): run_mmsft on a world-size-1 NCCL mesh
    at zero stages 1 and 3, DCP's async save and the resume. Returns B's
    and C's launches. On the CPU (tests/test_torch_smoke_bounds.py) the
    group is gloo and the wrappers run their plain versions: no launch
    floors."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from llamole_tpu_torch.train import trainer as trainer_mod
    from llamole_tpu_torch.train.optimizers import local_data
    from llamole_tpu_torch.train.workflow import run_mmsft

    gin, gin_bwd = kernels[1:3]
    out_dir = os.path.join(work, "mesh")
    Trainer = trainer_mod.Trainer
    save, wait = Trainer.save_checkpoint, Trainer.wait_for_checkpoints
    saves = []

    def timed_save(self, state, path):
        t0 = time.perf_counter()
        save(self, state, path)
        saves.append({"path": path, "dcp": self._use_dcp(),
                      "call_s": time.perf_counter() - t0, "wait_s": 0.0})

    def timed_wait(self):
        pending = self._pending is not None
        t0 = time.perf_counter()
        wait(self)
        if pending and saves:
            saves[-1]["wait_s"] += time.perf_counter() - t0

    on_card = model.device.type == "cuda"
    last_batch = []
    loss = model.loss

    def watched(batch, generator=None, train=True, noisy=None):
        if train:
            last_batch[:] = [batch]
        return loss(batch, generator, train, noisy)

    def run(name, zero, dcp, resume=None):
        args = list(llama_lora_args(os.path.join(out_dir, name)))
        args[2] = SimpleNamespace(**{
            **vars(args[2]), "mesh": MESH["mesh"], "zero_stage": zero,
            "save_steps": MESH["save_steps"],
            "resume_from_checkpoint": resume})
        if dcp:
            os.environ["LLAMOLE_ORBAX"] = "1"
        else:
            os.environ.pop("LLAMOLE_ORBAX", None)
        if resume is None:      # phase 9's start; a resume loads its own
            with torch.no_grad():
                for n, p in model.trainable_parameters().items():
                    local_data(p).copy_(phase9["start"][n])
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = run_mmsft(*args, prebuilt=(model, tok))
        wall = time.perf_counter() - t0
        with open(Path(out_dir) / name / "trainer_log.jsonl") as f:
            losses = [json.loads(line)["loss"] for line in f]
        return {"losses": losses, "steps": metrics["step_times"],
                "peak": torch.cuda.max_memory_allocated() if on_card else 0,
                "wall": wall,
                "eval_loss": metrics.get("eval_loss")}

    model.loss = watched
    Trainer.save_checkpoint, Trainer.wait_for_checkpoints = (timed_save,
                                                            timed_wait)
    reset_counts(*kernels)
    try:
        runs = {"a": run("a", 1, False)}
        finals = {"a": _snapshot_local(model)}
        runs["b"] = run("b", 3, True)
        finals["b"] = b_final = _snapshot_local(model)
        runs["c"] = run("c", 3, True, resume=os.path.join(out_dir, "b",
                                                          "checkpoint-2"))
    finally:
        del model.loss
        Trainer.save_checkpoint, Trainer.wait_for_checkpoints = save, wait
        os.environ.pop("LLAMOLE_ORBAX", None)
    launches = {"B": gin.launches, "C": gin_bwd.launches}
    backend = "nccl" if on_card else "gloo"
    if not dist.is_initialized() or dist.get_backend() != backend or \
            dist.get_world_size() != 1:
        fail(f"phase 18 did not run on a world-size-1 {backend} group")
    llm = model.llm
    sharded = [n for n, p in llm.named_parameters()
               if isinstance(p, DTensor)]
    print(f"mesh {MESH['mesh']} over {backend}: {len(sharded)} of "
          f"{len(list(llm.parameters()))} LLM leaves are DTensors, "
          f"{sum(1 for m in llm.modules() if 'FSDP' in type(m).__name__)} "
          f"FSDP2 units [{tag}]", flush=True)
    if not sharded:
        fail("phase 18: no LLM leaf is a DTensor")
    micro = sum(len(r["losses"]) for r in runs.values())
    if [len(runs[k]["losses"]) for k in "abc"] != [4, 4, 2]:
        fail(f"phase 18: micro steps {[len(r['losses']) for r in runs]}")
    base = phase9["losses"]
    gaps = {}
    for k in "ab":
        got = runs[k]["losses"]
        if not all(np.isfinite(got)):
            fail(f"phase 18 ({k}): non-finite loss {got}")
        gaps[k] = max(abs(x - y) for x, y in zip(got, base))
        for i, (x, y) in enumerate(zip(got, base)):
            print(f"mesh ({k}) zero {1 if k == 'a' else 3} micro step "
                  f"{i + 1}: loss {x:.6f}, phase 9 {y:.6f} (gap "
                  f"{abs(x - y):.3e}) [{tag}]", flush=True)
        print(f"mesh ({k}): largest gap to phase 9 {gaps[k]:.3e} (limit "
              f"{MESH['loss_gap']})", flush=True)
        if gaps[k] > MESH["loss_gap"]:
            fail(f"phase 18 ({k}) strays from phase 9: {gaps[k]}")
        final = phase9["final"]
        bundle_gap = max(float((finals[k][n] - final[n].float()).abs().max())
                         for n in final)
        moved = max(float((final[n].float() - phase9["start"][n].float())
                          .abs().max()) for n in final)
        print(f"mesh ({k}): trained bundle after update 2 differs from "
              f"phase 9's by {bundle_gap:.3e} (max abs; phase 9 moved an "
              f"element by up to {moved:.3e}; limit {MESH['bundle_gap']}) "
              f"[{tag}]", flush=True)
        if set(finals[k]) != set(final) or bundle_gap > MESH["bundle_gap"]:
            fail(f"phase 18 ({k}): the trained bundle strays from phase "
                 f"9's: {bundle_gap}")
    resumed = runs["c"]["losses"]
    want = runs["b"]["losses"][2:]
    print(f"mesh (c) resumed from (b)'s DCP checkpoint-2: losses "
          f"{resumed} against (b)'s steps 3-4 {want}", flush=True)
    if resumed != want:
        fail(f"phase 18: the resumed losses {resumed} differ from {want}")
    drift = max(float((local_data(p) - b_final[n]).abs().max())
                for n, p in model.trainable_parameters().items())
    print(f"mesh (c): trained bundle after update 2 differs from (b)'s by "
          f"{drift:.3e} (max abs)", flush=True)
    if drift != 0.0:
        fail(f"phase 18: the resumed run's bundle differs by {drift}")
    for k, r in runs.items():
        walls = [st["forward_s"] + st["backward_s"] + st["optimizer_s"]
                 for st in r["steps"]]
        split = [tuple(round(st[x], 3) for x in ("forward_s", "backward_s",
                                                 "optimizer_s"))
                 for st in r["steps"]]
        print(f"mesh ({k}): step walls {[round(w, 3) for w in walls]} s "
              f"(forward, backward, optimizer: {split}), "
              f"tokens/s {[round(st['tokens'] / w, 1) for st, w in zip(r['steps'], walls)]}, "
              f"run_mmsft {r['wall']:.3f} s, peak "
              f"{r['peak'] / 2**30:.2f} GiB (phase 9 {phase9['peak']}), "
              f"eval_loss {r['eval_loss']} [{tag}]", flush=True)
    for sv in saves:
        if sv["dcp"]:
            nbytes = _dir_bytes(Path(sv["path"]) / "dcp_state")
            print(f"DCP async save {Path(sv['path']).name}: call "
                  f"{sv['call_s']:.3f} s, wait {sv['wait_s']:.3f} s, "
                  f"{nbytes} bytes ({nbytes / 2**20:.1f} MiB) [{tag}]",
                  flush=True)
    if not any(sv["dcp"] for sv in saves):
        fail("phase 18: no DCP save")
    layers = model.graph_predictor.cfg.num_layer
    if on_card:
        check_launches("gin_aggregate (mesh)", launches["B"],
                       2 * layers * micro,
                       f"({layers} GraphCLIP + {layers} predictor layers) "
                       f"x {micro}")
        check_launches("gin_aggregate_backward (mesh)", launches["C"],
                       (layers - 1) * micro,
                       f"{layers - 1} predictor layers x {micro}")
    if on_card:   # B and C at the last batch's retro bank vs the CPU
        batch = model.batch_to_device(last_batch[0])
        check_predictor(model, tag, bank=(
            batch["retro_atoms"], batch["retro_edges"],
            batch["retro_node_mask"] & batch["retro_valid"][:, None]))
    dist.destroy_process_group()
    return launches


# phase 19: mesh inference and the pipeline on one card (a world-size-1
# NCCL mesh: NCCL refuses two ranks on one card). loss_gap: the pipelined
# loss against the plain forward's; grad_rel: the relative L2 gap of the
# LoRA gradients as one vector (bf16: each microbatch's products have
# half the rows, so cuBLAS may round them otherwise); leaf_rel: the
# largest single leaf's relative L2 gap (leaves near the noise floor
# stray further: 1.308e-2 in each of three runs on an H100 at 700 W, so
# a fault in one layer still shows, with room over that);
# analysis_tokens: the expansion's analysis budget (the planner's
# default is 512); decode_steps / decode_rows: the generate check.
MESH_INFER = {"mesh": "dp:1,tp:1", "records": 2, "microbatches": 2,
              "loss_gap": 1e-3, "grad_rel": 1e-2, "leaf_rel": 5e-2,
              "analysis_tokens": 64,
              "decode_steps": 32, "decode_rows": 8}


def unplaced_copy(model, tok):
    """A GraphLM of model's weights whose LLM is plain tensors again (a
    new LLM holding each leaf's local shard: whole on a world of one;
    model's own LLM, placed by phase 18 on a mesh that is gone, is
    dropped), sharing the graph modules; its trainable bundle as model's."""
    from llamole_tpu_torch.models.composite import GraphLM
    from llamole_tpu_torch.models.gllm import LLM
    from llamole_tpu_torch.train.optimizers import local_data
    old = dict(model.named_parameters())
    dev = model.device
    llm = LLM(model.llm.cfg, dtype=model.llm.dtype, device=dev)
    new = GraphLM(llm, model.graph_decoder, model.graph_predictor,
                  model.graph_encoder, tok, model.token_id_dict,
                  num_body_tokens=model.num_body_tokens,
                  lora_rank=model.lora_rank, cost_mlp=model.cost_mlp)
    if new.lora_scale != model.lora_scale:
        fail(f"phase 19: the copy's LoRA scale {new.lora_scale} is not "
             f"{model.lora_scale}")
    with torch.no_grad():
        for n, p in new.named_parameters():
            if n.startswith(("llm.", "connectors.")):
                p.copy_(local_data(old[n]))
    del model.llm, old
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return new


def _record_design(model, log):
    """Wrap model.design_molecule: log gets each call's analysis rows."""
    inner = model.design_molecule

    def wrapper(*args, **kwargs):
        analysis, smiles = inner(*args, **kwargs)
        log.append(np.asarray(analysis).tolist())
        return analysis, smiles

    model.design_molecule = wrapper


def _molqa(model, tok, mesh, sizes, designs):
    """run_molqa's design phase over sizes["records"] records at phase 8's
    settings (on `mesh` when given; the retro phase is held by
    _expansion); returns (results, wall)."""
    from llamole_tpu_torch.eval.workflow import run_molqa
    data_dir = Path(__file__).resolve().parent / "data"
    _record_design(model, designs)
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            args = dict(
                model_args=SimpleNamespace(adapter_name_or_path=None,
                                           property_oracle_path=None),
                data_args=SimpleNamespace(
                    dataset="molqa_drug_examples", dataset_dir=str(data_dir),
                    template="llama3", cutoff_len=128),
                training_args=SimpleNamespace(
                    per_device_eval_batch_size=2, output_dir=out_dir, seed=0,
                    mesh=mesh),
                finetuning_args=SimpleNamespace(),
                generating_args=SimpleNamespace(
                    max_new_tokens=sizes["max_new_tokens"], temperature=0.6,
                    top_p=0.9, do_sample=True, repetition_penalty=1.0,
                    speculative_tokens=None, speculative_ngram=2,
                    frontier_width=8))
            _sync_card()
            t0 = time.perf_counter()
            results = run_molqa(**args, max_records=sizes["records"],
                                prebuilt=(model, tok), do_retro=False,
                                score=False)
            _sync_card()
            return results, time.perf_counter() - t0
    finally:
        del model.design_molecule


def _expansion(model, smiles, sizes, mesh=None):
    """One greedy batched_one_step_reaction -> ((reactants, scores,
    analysis) per product, wall)."""
    from llamole_tpu_torch.models.composite import GenerationSettings
    gen = GenerationSettings(max_new_tokens=8, do_sample=False,
                             speculative_tokens=0)
    _sync_card()
    t0 = time.perf_counter()
    out = model.batched_one_step_reaction(
        smiles, topk=16, gen=gen, analysis_tokens=sizes["analysis_tokens"],
        generator=torch.Generator(device=model.device).manual_seed(0),
        mesh=mesh)
    _sync_card()
    return ([(r["reactants"], [float(x) for x in r["scores"]],
              r["analysis"]) for r in out], time.perf_counter() - t0)


def _decode(llm, tok, sizes):
    ids, mask = _prompt_batch(tok, sizes["decode_rows"], llm.device)
    _sync_card()
    t0 = time.perf_counter()
    out, _ = llm.generate(ids, mask, max_new_tokens=sizes["decode_steps"],
                          do_sample=False, spec_tokens=0)
    _sync_card()
    return out, time.perf_counter() - t0


def _lora_grads(llm):
    from llamole_tpu_torch.train.optimizers import local_data
    grads = {n: local_data(p.grad).float().clone()
             for n, p in llm.named_parameters()
             if "lora_" in n and p.grad is not None}
    for p in llm.parameters():
        p.grad = None
    return grads


def run_pipeline_check(llm, groups, batch, tag, sizes):
    """Phase 19 (b): forward and backward of pipeline_lm_loss on phase
    9's batch with sizes["microbatches"] microbatches (the mesh's pp axis
    1) against the plain forward's lm_loss, in turns (plain, pipeline,
    pipeline, plain): the loss within loss_gap, the LoRA gradients (one
    vector) within grad_rel relative L2 and each leaf within leaf_rel,
    each run's wall and peak. Returns the record."""
    from llamole_tpu_torch.models.gllm.model import lm_loss
    from llamole_tpu_torch.parallel.pipeline import pipeline_lm_loss
    from llamole_tpu_torch.utils.constants import IGNORE_INDEX
    on_card = llm.device.type == "cuda"
    b = {k: torch.as_tensor(np.asarray(batch[k]), device=llm.device)
         for k in ("input_ids", "attention_mask", "labels")}
    b["input_ids"] = b["input_ids"].long()
    runs = []
    for kind in ("plain", "pipeline", "pipeline", "plain"):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _sync_card()
        t0 = time.perf_counter()
        if kind == "pipeline":
            loss = pipeline_lm_loss(llm, groups, b["input_ids"],
                                    b["attention_mask"], b["labels"],
                                    num_microbatches=sizes["microbatches"])
        else:
            logits, _, _ = llm(input_ids=b["input_ids"],
                               attention_mask=b["attention_mask"])
            loss = lm_loss(logits, b["labels"], IGNORE_INDEX)
            del logits
        loss.backward()
        _sync_card()
        runs.append({"kind": kind, "wall": time.perf_counter() - t0,
                     "loss": float(loss.detach()), "grads": _lora_grads(llm),
                     "peak": (torch.cuda.max_memory_allocated() / 2**30
                              if on_card else 0.0)})
        del loss
    plain, pipe = runs[0], runs[1]
    gap = abs(pipe["loss"] - plain["loss"])
    names = sorted(plain["grads"])
    diff = torch.stack([(pipe["grads"][n] - plain["grads"][n]).norm()
                        for n in names if n in pipe["grads"]])
    norm = torch.stack([plain["grads"][n].norm() for n in names])
    rel = float(diff.norm() / norm.norm().clamp_min(1e-30))
    leaf = (diff / norm.clamp_min(1e-30))
    worst = names[int(leaf.argmax())]
    repeat = (runs[2]["loss"] == pipe["loss"]
              and runs[3]["loss"] == plain["loss"])
    shape = tuple(b["input_ids"].shape)
    print(f"phase 19 (b) pipeline_lm_loss on {shape} with "
          f"{sizes['microbatches']} microbatches (pp 1): loss "
          f"{pipe['loss']:.6f}, plain forward {plain['loss']:.6f} (gap "
          f"{gap:.3e}, limit {sizes['loss_gap']}); {len(names)} LoRA "
          f"gradients, relative L2 gap {rel:.3e} (limit "
          f"{sizes['grad_rel']}), per leaf median "
          f"{float(leaf.median()):.3e}, largest {float(leaf.max()):.3e} "
          f"({worst}; limit {sizes['leaf_rel']}); forward + backward in turns "
          f"{[(r['kind'], round(r['wall'], 3)) for r in runs]} s, peaks "
          f"{[round(r['peak'], 2) for r in runs]} GiB; repeated losses "
          f"equal: {repeat} [{tag}]", flush=True)
    if not np.isfinite(pipe["loss"]) or gap > sizes["loss_gap"]:
        fail(f"phase 19 (b): the pipelined loss {pipe['loss']} strays from "
             f"the plain forward's {plain['loss']}")
    if set(pipe["grads"]) != set(plain["grads"]) or not names \
            or rel > sizes["grad_rel"]:
        fail(f"phase 19 (b): the LoRA gradients stray ({rel})")
    if float(leaf.max()) > sizes["leaf_rel"]:
        fail(f"phase 19 (b): the LoRA gradient of {worst} strays "
             f"({float(leaf.max())})")
    return {"loss_gap": gap, "grad_rel": rel,
            "leaf_max": float(leaf.max()),
            "walls": [(r["kind"], r["wall"]) for r in runs],
            "peaks": [r["peak"] for r in runs]}


def run_mesh_inference(model, tok, kernels, tag, phase9, sizes=None):
    """Phase 19 (module docstring), after phase 18 on its model: (a)
    run_molqa, one expansion and a greedy decode without a mesh, then on
    the world-size-1 mesh (the LLM placed as DTensors), each pair equal;
    (b) run_pipeline_check. Returns A's and B's launches in (a)'s mesh
    run. On the CPU (tests/test_torch_smoke_bounds.py) the group is gloo
    and the wrappers run their plain versions: no launch floors."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from llamole_tpu_torch.parallel.mesh import MeshGroups, mesh_from_string
    sizes = dict(sizes or {**MESH_INFER, "max_new_tokens": 128})
    on_card = model.device.type == "cuda"
    t_phase = time.perf_counter()
    model = unplaced_copy(model, tok)
    fused, gin = kernels[:2]
    # (a) without the mesh: the LLM's decode replays its CUDA graph
    plain_designs, mesh_designs = [], []
    want, want_wall = _molqa(model, tok, "", sizes, plain_designs)
    smiles = [r["llm_smiles"] for r in want if r["llm_smiles"]] or \
        MOLECULES[:2]
    want_exp, want_exp_s = _expansion(model, smiles, sizes)
    want_dec, want_dec_s = _decode(model.llm, tok, sizes)
    # on the mesh: run_molqa starts the group and places the LLM
    # kernel counts from 0 over the mesh's design and expansion
    reset_counts(*kernels)
    got, got_wall = _molqa(model, tok, sizes["mesh"], sizes, mesh_designs)
    backend = "nccl" if on_card else "gloo"
    if not dist.is_initialized() or dist.get_backend() != backend or \
            dist.get_world_size() != 1:
        fail(f"phase 19 did not run on a world-size-1 {backend} group")
    groups = MeshGroups(mesh_from_string(sizes["mesh"], model.device.type))
    llm = model.llm
    placed = [n for n, p in llm.named_parameters()
              if isinstance(p, DTensor)]
    got_exp, got_exp_s = _expansion(model, smiles, sizes, groups)
    launches = {"A": getattr(fused, "launches", 0),
                "A_mma": getattr(fused, "launches_mma", 0),
                "A_fma": getattr(fused, "launches_fma", 0),
                "B": getattr(gin, "launches", 0)}
    got_dec, got_dec_s = _decode(llm, tok, sizes)
    same = {
        "analysis tokens": plain_designs == mesh_designs,
        "SMILES": [r["llm_smiles"] for r in want]
        == [r["llm_smiles"] for r in got],
        "responses": [r["llm_response"] for r in want]
        == [r["llm_response"] for r in got],
        "expansion": want_exp == got_exp,
        "decode": bool(torch.equal(want_dec, got_dec))}
    print(f"phase 19 (a) mesh {sizes['mesh']} over {backend}: "
          f"{len(placed)} of {len(list(llm.parameters()))} LLM leaves are "
          f"DTensors; run_molqa on {len(got)} records {got_wall:.3f} s "
          f"(without the mesh {want_wall:.3f} s"
          f"{', its decode graphed' if on_card else ''}); "
          f"expansion of {len(smiles)} molecules {got_exp_s:.3f} s "
          f"({want_exp_s:.3f} s without); {sizes['decode_rows']} x "
          f"{sizes['decode_steps']} greedy decode {got_dec_s:.3f} s eager "
          f"on the mesh, {want_dec_s:.3f} s without; equal: {same}; "
          f"A {launches['A']} (mma {launches['A_mma']}, fma "
          f"{launches['A_fma']}), B {launches['B']} launches in the mesh's "
          f"design and expansion [{tag}]", flush=True)
    if not placed:
        fail("phase 19: no LLM leaf is a DTensor")
    bad = [k for k, ok in same.items() if not ok]
    if bad:
        fail(f"phase 19 (a): the mesh run differs from the mesh-less one in "
             f"{bad}")
    if len(got) != sizes["records"]:
        fail(f"phase 19 (a): run_molqa answered {len(got)} records")
    if on_card:
        check_one_body(fused, "mma", "phase 19 run_molqa on the mesh")
        steps = diffusion_steps(model)
        check_launches("fused_block_attention (mesh run_molqa)",
                       launches["A"], model.graph_decoder.cfg.depth * steps,
                       f"{model.graph_decoder.cfg.depth} x {steps} x 1 "
                       "design batch")
        check_launches("gin_aggregate (mesh expansion)", launches["B"],
                       GIN_LAYERS * (1 + len(smiles)),
                       f"{GIN_LAYERS} x (1 splice + {len(smiles)} products)")
    pipe = run_pipeline_check(llm, groups, phase9["batch"], tag, sizes)
    dist.destroy_process_group()
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s [{tag}]",
          flush=True)
    return {**launches, "pipeline": pipe}


def profile_training_step(model, batch, tag):
    """One more training micro step (forward + backward, no update) of the
    last batch under torch.profiler: the device's busy share of the wall
    (the summed kernel time; the profiler's own host cost makes it a lower
    bound) and the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = model.trainable_parameters()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.loss(batch, gen)[0].backward()       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.loss(batch, gen)[0].backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for p in params.values():
        p.grad = None
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:6]
    print(f"training step under the profiler: wall {wall:.3f} s, device "
          f"busy {busy:.3f} s = {100 * busy / wall:.1f}% over "
          f"{sum(e.count for e in kernels)} kernel launches [{tag}]")
    for e in top:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")


# Phase 11, the learned-weights stack on the card: the reference widths
# (GraphDiT 1024 x 28, 16 heads, 100 diffusion steps; the predictor and
# GraphCLIP 5 x 300; the oracle at its defaults, 3 x 128), batch 64,
# steps cut to 10 (GraphDiT) and 20 (the rest)
STACK_SIZES = {
    "train_records": 128, "eval_records": 4,
    "graphdit": dict(hidden_size=1024, depth=28, num_heads=16,
                     diffusion_steps=100, steps=10, batch_size=64),
    "predictor": dict(hidden_size=GIN_HIDDEN, num_layer=GIN_LAYERS,
                      steps=20, batch_size=64),
    "cost_mlp": dict(steps=20, batch_size=64),
    "graphclip": dict(hidden_size=GIN_HIDDEN, num_layer=GIN_LAYERS,
                      steps=20, batch_size=64),
    "oracle": dict(steps=20, batch_size=64),
    "mmsft_steps": 4,
    "eval": dict(per_device_eval_batch_size=4, max_new_tokens=64,
                 expansion_topk=50, iterations=2, max_planning_time=10.0),
}
# the GIN layers of each pretraining (a step launches B and C once a layer)
STACK_GIN_LAYERS = {"predictor": "num_layer", "graphclip": "num_layer",
                    "oracle": 3}
# (a fixed-label loss whose last 5 steps must average below its first 5)
STACK_FALLING = ("predictor", "oracle", "cost_mlp")


# one molecule past kernel C's staged body (161 nodes): 162 heavy atoms,
# which pretrain._bucket rounds up to a bank of 168
LARGE_MOLECULE = "OC" + "C" * 159 + "N"


def _stack_batch(records, n_pad=None, device="cuda", large=False):
    """The first pretraining batch of the predictor (random.Random(0) over
    its (product, label) rows, batch 64) padded to the pretraining bank's
    N: the largest product rounded up to 8 (pretrain._bucket). With
    `large`, its last graph is LARGE_MOLECULE's, which sets N."""
    import random

    from llamole_tpu_torch.chem.featurize import smiles_to_graph
    from llamole_tpu_torch.train import pretrain
    rows = pretrain._retro_rows(records)
    rng = random.Random(0)
    graphs = [rows[rng.randrange(len(rows))][0] for _ in range(64)]
    if large:
        graphs[-1] = smiles_to_graph(LARGE_MOLECULE)
        rows = rows + [(graphs[-1], 0)]
    n = n_pad or pretrain._bucket(rows)
    return pretrain._graph_tensors(graphs, n, device)


def large_n_records(records):
    """The corpus plus one record whose designed molecule is
    LARGE_MOLECULE (a GraphCLIP row: a designed molecule and its prose)."""
    big = {"instruction": "Design a long-chain amino alcohol.", "input": "",
           "output": "The designed molecule is: <design_start><design_end>"
                     f"<mol_start>{LARGE_MOLECULE}<mol_end>.",
           "property": {}, "retro": []}
    return list(records) + [big]


def time_pretrain_bank(gin, gin_bwd, records, tag):
    """Kernels B and C at the pretraining bank (64, n, H) f32, H = 300
    (predictor, GraphCLIP) and 128 (the oracle), and at the bank one large
    molecule widens (64, 168, 300) f32 (kernel C's second body): call and
    device time, the plain version's time, bound and share."""
    from llamole_tpu_torch.ops.gin import dense_graph_inputs
    from llamole_tpu_torch.ops.gin_aggregate import (
        gin_aggregate_backward_reference, gin_aggregate_reference,
        gin_backward_body)

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for h, prefix, large in ((GIN_HIDDEN, "pretrain", False),
                             (128, "pretrain_oracle", False),
                             (GIN_HIDDEN, "large_n", True)):
        atoms, edges, mask = _stack_batch(records, large=large)
        edge, adj = dense_graph_inputs(edges, mask, torch.float32)
        b, n = atoms.shape
        body = gin_backward_body(n)
        x = torch.randn(b, n, h, device="cuda", generator=gen)
        table = torch.randn(5, h, device="cuda", generator=gen)
        g = torch.randn(b, n, h, device="cuda", generator=gen)
        for name, fn, plain, key, bwd in (
                ("gin_aggregate", lambda: gin(x, edge, adj, table),
                 lambda: gin_aggregate_reference(x, edge, adj, table),
                 "gin_aggregate_kernel", False),
                ("gin_aggregate_backward",
                 lambda: gin_bwd(x, edge, adj, table, g),
                 lambda: gin_aggregate_backward_reference(x, edge, adj,
                                                          table, g),
                 "gin_backward_kernel", True)):
            with torch.no_grad():
                got, want = fn(), plain()
                got = got if bwd else (got,)
                want = want if bwd else (want,)
                err = max(float((a - r).abs().max())
                          for a, r in zip(got, want))
                ok = all(bool(((a - r).abs() <= 1e-4 + 1e-4 * r.abs()).all())
                         for a, r in zip(got, want))
                if not ok:
                    fail(f"{name} disagrees at the pretraining bank "
                         f"({b}, {n}, {h}): {err}")
                rec = time_kernel(f"{name} at the pretraining bank "
                                  f"({b}, {n}, {h}) f32", fn, plain, key,
                                  tag)
                if bwd and body == "smem":
                    rec.update(second_body_at(
                        gin_bwd, (x, edge, adj, table, g),
                        f"the pretraining bank ({b}, {n}, {h}) f32", tag))
            bound_ms, bound_by = gin_bound((x, edge, adj, table, g), bwd)
            share = bound_ms / rec["device_ms"]
            if "second_body_device_ms" in rec:
                rec["second_body_share"] = (bound_ms
                                            / rec["second_body_device_ms"])
            print(f"{name} bound at ({b}, {n}, {h}) {bound_ms * 1e3:.3f} us "
                  f"({bound_by}), {100 * share:.1f}% of it; max_abs_err "
                  f"{err:.3e} [{tag}]", flush=True)
            out.setdefault(name, {}).update({
                f"{prefix}_{k}": v for k, v in {
                    **rec, "bound_ms": bound_ms, "bound_by": bound_by,
                    "share": share, "shape": [b, n, h],
                    "max_abs_err": err,
                    **({"body": body} if bwd else {})}.items()})
    return out


def _capture_saves(classes):
    """Every module the pretraining loops save, by (class name, output
    directory): each class's save_pretrained records its instance, then
    saves. Returns (saved, the original methods)."""
    saved, originals = {}, {}
    for cls in classes:
        originals[cls] = cls.save_pretrained

        def save(self, output_dir, _orig=originals[cls]):
            saved[(type(self).__name__, output_dir)] = self
            _orig(self, output_dir)
        cls.save_pretrained = save
    return saved, originals


def _reload_identical(saved, paths, records, device, tag):
    """Each saved module read back through the port's loader
    (models/loader.load_graph_modules; the oracle through its
    from_pretrained, which eval/scoring uses) gives bit-identical
    forwards on a corpus batch."""
    from llamole_tpu_torch.chem.fingerprint import morgan_fingerprint
    from llamole_tpu_torch.models.loader import load_graph_modules
    from llamole_tpu_torch.models.oracle import PropertyOracle
    from llamole_tpu_torch.train import stack

    args = SimpleNamespace(**{k: v for k, v in stack.eval_args(
        paths, STACK_SIZES["eval"], 0).items() if k.endswith("_path")},
        diffusion_sampling_steps=None)
    decoder, encoder, predictor, cost_mlp = load_graph_modules(args, device)
    oracle = PropertyOracle.from_pretrained(paths["oracle"], device=device)
    atoms, edges, mask = _stack_batch(records, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    fps = torch.as_tensor(np.stack([morgan_fingerprint(
        "CC(=O)Oc1ccccc1C(=O)O", radius=2, n_bits=2048)] * 4),
        dtype=torch.float32, device=device)
    dcfg = decoder.cfg
    b, n = 4, dcfg.max_n_nodes
    X = torch.nn.functional.one_hot(torch.randint(
        dcfg.Xdim, (b, n), device=device, generator=gen), dcfg.Xdim).float()
    E = torch.nn.functional.one_hot(torch.randint(
        dcfg.Edim, (b, n, n), device=device, generator=gen),
        dcfg.Edim).float()
    nmask = torch.ones(b, n, dtype=torch.bool, device=device)
    y = torch.full((b, dcfg.ydim), float("nan"), device=device)
    txt = torch.full((b, dcfg.text_dim), float("nan"), device=device)
    t = torch.rand(b, device=device, generator=gen)
    pairs = {
        "graphdit": (saved["GraphDiT", paths["graphdit"]].denoiser,
                     decoder.denoiser, (X, E, nmask, y, txt, t)),
        "graphclip": (saved["GraphCLIP", paths["graphclip"]], encoder,
                      (atoms, edges, mask)),
        "predictor": (saved["GraphPredictor", paths["predictor"]],
                      predictor, (atoms, edges, mask, None)),
        "cost_mlp": (saved["CostMLP", paths["predictor"]], cost_mlp,
                     (fps,)),
        "oracle": (saved["PropertyOracle", paths["oracle"]], oracle,
                   (atoms, edges, mask)),
    }
    for name, (before, after, inputs) in pairs.items():
        with torch.no_grad():
            a, r = before.eval()(*inputs), after.eval()(*inputs)
        a, r = (a if isinstance(a, tuple) else (a,),
                r if isinstance(r, tuple) else (r,))
        if not all(torch.equal(u, v) for u, v in zip(a, r)):
            fail(f"the reloaded {name} is not bit-identical to the saved")
        print(f"stack: {name} saved, reloaded through the loader, forward "
              f"bit-identical [{tag}]", flush=True)


LARGE_N_STEPS = 3


def _large_n_pretrain(records, work, kernels, sizes, device, tag):
    """GraphCLIP's pretraining through its entry for LARGE_N_STEPS steps on
    the corpus plus LARGE_MOLECULE: every bank is 168 wide, so on the card
    each step's C launches take the second body, at least layers x steps
    of them (and, run inside run_stack, no plain-version call). Returns
    C's launches per body ({} on the CPU)."""
    from llamole_tpu_torch.train import pretrain

    path = os.path.join(work, "corpus_large_n.json")
    with open(path, "w") as f:
        json.dump(large_n_records(records), f)
    kw = {**sizes["graphclip"], "steps": LARGE_N_STEPS}
    if kernels:
        reset_counts(*kernels)
    t0 = time.perf_counter()
    m = pretrain.pretrain_graphclip(path, os.path.join(work, "clip_large_n"),
                                    seed=0, device=device, **kw)
    wall = time.perf_counter() - t0
    losses = np.asarray(m["losses"])
    if len(losses) != LARGE_N_STEPS or not np.isfinite(losses).all():
        fail(f"large-N graphclip pretraining losses {losses}")
    line = (f"stack large N: graphclip on the corpus + one "
            f"{len(LARGE_MOLECULE)}-atom molecule, {LARGE_N_STEPS} steps in "
            f"{wall:.2f} s, losses {[round(float(v), 4) for v in losses]}")
    if not kernels:
        print(line + f" [{tag}]", flush=True)
        return {}
    gin_bwd = kernels[2]
    need = kw["num_layer"] * LARGE_N_STEPS
    counts = {k: getattr(gin_bwd, k) for k in BWD_COUNTS}
    print(line + f"; kernel C {counts} (need >= {need} = {kw['num_layer']} "
          f"layers x {LARGE_N_STEPS} steps on the global body) [{tag}]",
          flush=True)
    if counts["launches_global"] < need or counts["launches_smem"]:
        fail(f"large-N pretraining: kernel C launches {counts}, need >= "
             f"{need} on the global body and none on the staged one")
    return counts


def run_stack(kernels, tag, device="cuda", sizes=None):
    """Phase 11: the learned-weights stack (llamole_tpu_torch/train/
    stack.py's stages) on the card. Returns the kernel-B and kernel-C
    launches of the pretrainings and, on the card, their records at the
    pretraining bank. On the CPU (device "cpu", small `sizes`: the CPU
    test of this phase) the wrappers run their plain versions and no
    launch is counted."""
    from llamole_tpu_torch.config import get_infer_args, get_train_args
    from llamole_tpu_torch.data.synthetic import write_corpus
    from llamole_tpu_torch.eval.workflow import run_molqa
    from llamole_tpu_torch.models.graphclip.model import GraphCLIP
    from llamole_tpu_torch.models.graphdit import GraphDiT
    from llamole_tpu_torch.models.oracle import PropertyOracle
    from llamole_tpu_torch.models.retro import CostMLP, GraphPredictor
    from llamole_tpu_torch.train import pretrain, stack
    from llamole_tpu_torch.train.workflow import run_mmsft

    sizes = sizes or STACK_SIZES
    on_card = device == "cuda"
    gin, gin_bwd = kernels[1:3] if on_card else (None, None)

    def memory():
        return (torch.cuda.max_memory_allocated() / 2**30 if on_card
                else float("nan"))

    with tempfile.TemporaryDirectory() as d:
        paths = stack.stack_paths(d)
        t0 = time.perf_counter()
        m_train = write_corpus(paths["corpus_train"], sizes["train_records"],
                               seed=0)
        m_eval = write_corpus(paths["corpus_eval"], sizes["eval_records"],
                              seed=100)
        print(f"stack corpus: {sizes['train_records']} train + "
              f"{sizes['eval_records']} eval records in "
              f"{time.perf_counter() - t0:.2f} s ({m_train} / {m_eval}) "
              f"[{tag}]", flush=True)
        with open(paths["corpus_train"]) as f:
            records = json.load(f)

        saved, originals = _capture_saves((GraphDiT, GraphCLIP,
                                           GraphPredictor, CostMLP,
                                           PropertyOracle))
        launches = {"B": 0, "C": 0}
        try:
            with plain_gin_calls(on_card) as plain_calls:
                for stage, fn, out in (
                        ("graphdit", pretrain.pretrain_graphdit, "graphdit"),
                        ("predictor", pretrain.pretrain_predictor,
                         "predictor"),
                        ("cost_mlp", pretrain.pretrain_cost_mlp, "predictor"),
                        ("graphclip", pretrain.pretrain_graphclip,
                         "graphclip"),
                        ("oracle", pretrain.pretrain_property_oracle,
                         "oracle")):
                    kw = sizes[stage]
                    if on_card:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        reset_counts(*kernels)
                    t0 = time.perf_counter()
                    m = fn(paths["corpus_train"], paths[out], seed=0,
                           device=device, **kw)
                    if on_card:
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    losses = np.asarray(m["losses"])
                    if len(losses) != kw["steps"] or not np.isfinite(
                            losses).all():
                        fail(f"{stage} pretraining losses {losses}")
                    line = (f"stack {stage}: {kw['steps']} steps in "
                            f"{wall:.2f} "
                            f"s, loss first {losses[0]:.4f} last "
                            f"{losses[-1]:.4f} (mean of the first 5 "
                            f"{losses[:5].mean():.4f}, last 5 "
                            f"{losses[-5:].mean():.4f}), peak "
                            f"{memory():.2f} GiB")
                    if stage in STACK_FALLING and not (
                            losses[-5:].mean() < losses[:5].mean()):
                        fail(f"{stage} pretraining loss did not fall: "
                             f"{losses}")
                    if on_card and stage in STACK_GIN_LAYERS:
                        layers = STACK_GIN_LAYERS[stage]
                        if isinstance(layers, str):
                            layers = kw[layers]
                        need = layers * kw["steps"]
                        line += (f"; kernel B {gin.launches}, kernel C "
                                 f"{gin_bwd.launches} launches (need >= "
                                 f"{need} "
                                 f"= {layers} layers x {kw['steps']} steps)")
                        if min(gin.launches, gin_bwd.launches) < need:
                            fail(f"{stage}: B {gin.launches} / C "
                                 f"{gin_bwd.launches} launches < {need}")
                        launches["B"] += gin.launches
                        launches["C"] += gin_bwd.launches
                    print(line + f" [{tag}]", flush=True)
                large_n = _large_n_pretrain(records, d,
                                            kernels if on_card else (), sizes,
                                            device, tag)
                if large_n:
                    launches["large_n"] = large_n
        finally:
            for cls, orig in originals.items():
                cls.save_pretrained = orig
        print(f"stack pretraining: kernel B {launches['B']}, kernel C "
              f"{launches['C']} launches; plain-version calls "
              f"{plain_calls[0]} [{tag}]", flush=True)

        _reload_identical(saved, paths, records, device, tag)
        del saved
        if on_card:
            torch.cuda.empty_cache()

        os.makedirs(paths["llm"], exist_ok=True)
        llm_cfg = stack.llm_config(stack.sizes(False)["llm"])
        with open(os.path.join(paths["llm"], "config.json"), "w") as f:
            json.dump(llm_cfg, f, indent=1)
        mmsft = {**stack.sizes(False)["mmsft"],
                 "max_steps": sizes["mmsft_steps"]}
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = run_mmsft(*get_train_args(stack.mmsft_args(
            paths, mmsft, 0)), device=device)
        wall = time.perf_counter() - t0
        if (metrics["train_steps"] != sizes["mmsft_steps"]
                or not np.isfinite(metrics["train_loss"])
                or not os.path.exists(os.path.join(paths["mmsft"],
                                                   "llm.msgpack"))):
            fail(f"stack mmsft: {metrics}")
        print(f"stack mmsft (full finetuning, LLM {llm_cfg['hidden_size']}"
              f" x {llm_cfg['num_hidden_layers']}, tied embeddings, over "
              f"the trained graph modules): {metrics['train_steps']} steps "
              f"in {wall:.2f} s, train loss {metrics['train_loss']:.4f}, "
              f"peak {memory():.2f} GiB [{tag}]", flush=True)

        ev = sizes["eval"]
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = run_molqa(*get_infer_args(stack.eval_args(paths, ev, 0)),
                            expansion_topk=ev["expansion_topk"],
                            iterations=ev["iterations"],
                            max_planning_time=ev["max_planning_time"],
                            share_planning_wall=False, device=device)
        wall = time.perf_counter() - t0
        with open(os.path.join(paths["eval"], "molqa_results.json")) as f:
            summary = json.load(f)["summary"]
        if (len(results) != sizes["eval_records"]
                or "property_accuracy" not in summary
                or "property_mae" not in summary):
            fail(f"stack run_molqa summary {summary}")
        print(f"stack run_molqa ({len(results)} records, oracle scored): "
              f"{wall:.2f} s, peak {memory():.2f} GiB, summary "
              f"{json.dumps(summary)} [{tag}]", flush=True)
    records_out = time_pretrain_bank(gin, gin_bwd, records, tag) \
        if on_card else {}
    return launches, records_out


# Phase 12, weight interchange at the slice's width (the Llama-3.1-8B
# shape, bf16): phase 9's adapter and checkpoint reload bit-identically,
# the frozen base goes out as an HF checkpoint (5 GB shards), merge_adapter
# merges the adapter into it through its normal entry, and the merged
# export reloads and serves
INTERCHANGE = {"shard_gb": 5.0, "requests": 3, "max_new_tokens": 64,
               "retro_iterations": 5, "retro_max_time": 10.0}
# The chip machine's disk takes at most 45 GiB of writes in one run,
# deleted files included. The base export and the merged HF export are
# 2 x 16.06 GB at 8B; merge_adapter's model.msgpack (16.06 GB more) would
# pass the budget, so phase 12 streams it through the same writer into a
# byte counter (timed, its size and sha256 kept) instead of onto the disk,
# and holds it to a second stream of the reloaded merged LLM
WRITE_BUDGET = 45 * 2 ** 30
# merged against unmerged last-token logits in bf16: max |diff| over max
# |logit| of the unmerged model. The same comparison at a small width on
# the CPU (tests/test_torch_smoke_bounds.py, bf16, 2 layers) gives about
# 1e-2, a few bf16 ulps of the largest logit (the logits leave the head
# in bf16); the limit is 5x that, and the CPU test holds its value below
# a third of it
MERGE_LOGIT_TOL = 5e-2
PROMPT = "Design a drug-like molecule with low synthetic accessibility."
GIB = 2 ** 30


@contextlib.contextmanager
def capture_checkpoints():
    """What each Trainer.save_checkpoint saved, by directory name: clones
    of the trainable bundle, of the optimizer's state and of the
    generator's state, with the trainer's arguments."""
    from llamole_tpu_torch.train.trainer import Trainer

    saved, orig = {}, Trainer.save_checkpoint

    def save(self, state, path):
        orig(self, state, path)
        opt = self.optimizer
        saved[os.path.basename(path)] = {
            "params": _snapshot(self.params), "count": opt.count,
            "mini_step": opt.mini_step, "step": state.step,
            **{k: _snapshot(getattr(opt, k)) for k in ("mu", "nu", "acc")},
            "proj": _snapshot(getattr(opt, "proj", {})),
            "generator": state.generator.get_state().clone(),
            "args": self.args, "updates": self.num_training_steps}

    Trainer.save_checkpoint = save
    try:
        yield saved
    finally:
        Trainer.save_checkpoint = orig


class _ByteCounter:
    """A file that keeps only the count and the sha256 of the bytes
    written to it."""

    def __init__(self):
        self.nbytes = 0
        self.sha = hashlib.sha256()

    def write(self, data):
        view = memoryview(data)
        self.nbytes += view.nbytes
        self.sha.update(view)


def _msgpack_to_counter(tree, path=None):
    """save_pytree's writer, leaf by leaf, into a byte counter: the size
    and sha256 of what model.msgpack would hold, without the disk write
    (WRITE_BUDGET)."""
    from llamole_tpu_torch.utils import serialization

    counter = _ByteCounter()
    serialization._write(counter, tree)
    return counter


@contextlib.contextmanager
def timed_calls(module, names, log):
    """module.<name> timed (wall seconds between synchronizations) for
    each name, appended to log[name]."""
    origs = {n: getattr(module, n) for n in names}
    for n in names:
        log.setdefault(n, [])
        timed(module, n, log[n])
    try:
        yield log
    finally:
        for n, fn in origs.items():
            setattr(module, n, fn)


def llm_base_bytes(llm) -> int:
    return sum(p.numel() * p.element_size()
               for n, p in llm.named_parameters() if "lora_" not in n)


def check_reload(model, train_dir, saved, tag):
    """Phase 12, step 1: phase 9's final save (adapter.msgpack and the
    connectors) reloads into the model, and its last checkpoint-N into a
    new Trainer, bit-identically: the bundle, the optimizer's count,
    mini_step, mu, nu and acc, the step and the generator."""
    from llamole_tpu_torch.train.trainer import Trainer

    params = model.trainable_parameters()
    before = _snapshot(params)
    model.load_trainable(train_dir)
    changed = [n for n in params if not torch.equal(params[n], before[n])]
    name = max(saved, key=lambda k: saved[k]["step"])
    rec = saved[name]
    args = SimpleNamespace(**{**vars(rec["args"]), "output_dir": None})
    trainer = Trainer(lambda batch, gen: None, params, args, rec["updates"])
    state = trainer.load_checkpoint(trainer.init_state(1),
                                    os.path.join(train_dir, name))
    opt = trainer.optimizer
    bad = [n for n in params if not torch.equal(params[n], rec["params"][n])]
    bad += [f"{k}:{n}" for k in ("mu", "nu", "acc")
            for n, t in getattr(opt, k).items()
            if not torch.equal(t, rec[k][n])]
    bad += [k for k, a, b in (("count", opt.count, rec["count"]),
                              ("mini_step", opt.mini_step, rec["mini_step"]),
                              ("step", state.step, rec["step"])) if a != b]
    if not torch.equal(state.generator.get_state(), rec["generator"]):
        bad.append("generator")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(before[n])
    if changed or bad:
        fail(f"phase 9's output did not reload bit-identically: adapter "
             f"{changed[:3]}, {name} {bad[:3]}")
    print(f"interchange: phase 9's adapter.msgpack + connectors and {name} "
          f"(trainable.msgpack, opt_state.msgpack: count {opt.count}, "
          f"mini_step {opt.mini_step}, {len(params)} mu / nu / acc leaves) "
          f"reload bit-identically [{tag}]", flush=True)


def interchange_export(model, work, train_dir, saved, tag, sizes=None):
    """Phase 12, step 1, before the slice is freed: the reload checks,
    the frozen base exported as an HF checkpoint into work/base (timed),
    the graph modules saved with save_pretrained(save_graph_modules=True)
    into work/modules. Fails up front when the disk cannot hold what the
    phase writes."""
    from llamole_tpu_torch.models.gllm.convert import export_hf_weights

    sizes = sizes or INTERCHANGE
    check_reload(model, train_dir, saved, tag)
    graph = sum(p.numel() * 4 for n, p in model.named_parameters()
                if n.startswith(("graph_decoder.", "graph_encoder.",
                                 "graph_predictor.")))
    need = 2 * llm_base_bytes(model.llm) + graph + 2 * GIB
    free = shutil.disk_usage(work).free
    print(f"interchange disk: {free / GIB:.2f} GiB free under {work}, the "
          f"phase writes up to {need / GIB:.2f} GiB (the base and the "
          f"merged HF export, the graph modules; model.msgpack's "
          f"{llm_base_bytes(model.llm) / GIB:.2f} GiB go to a byte counter:"
          f" the machine takes {WRITE_BUDGET / GIB:.0f} GiB of writes a "
          f"run) [{tag}]", flush=True)
    if free < need:
        raise RuntimeError(f"phase 12 needs {need} bytes of disk under "
                           f"{work}; {free} are free")
    base = os.path.join(work, "base")
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    nbytes = export_hf_weights(model.llm, base, shard_gb=sizes["shard_gb"])
    wall = time.perf_counter() - t0
    shards = sorted(f for f in os.listdir(base) if f.endswith(".safetensors"))
    print(f"interchange export of the base: {nbytes} bytes in {wall:.3f} s "
          f"= {nbytes / wall / 1e9:.3f} GB/s, {len(shards)} shard(s) of at "
          f"most {sizes['shard_gb']} GiB [{tag}]", flush=True)
    t0 = time.perf_counter()
    model.save_pretrained(os.path.join(work, "modules"),
                          save_graph_modules=True)
    print(f"interchange: graph modules and connectors saved in "
          f"{time.perf_counter() - t0:.3f} s [{tag}]", flush=True)
    return {"export_bytes": nbytes, "export_s": wall, "shards": len(shards)}


def _interchange_args(work, **extra):
    mods = os.path.join(work, "modules")
    return {"model_name_or_path": os.path.join(work, "base"),
            "graph_decoder_path": os.path.join(mods, "graph_decoder"),
            "graph_encoder_path": os.path.join(mods, "graph_encoder"),
            "graph_predictor_path": os.path.join(mods, "graph_predictor"),
            "template": "llama3", "finetuning_type": "lora", "lora_rank": 8,
            "compute_dtype": "bfloat16", **extra}


def _build(args, device):
    from llamole_tpu_torch.config import get_infer_args
    from llamole_tpu_torch.models.loader import build_graph_lm

    m, d, _, f, _ = get_infer_args(args)
    return build_graph_lm(m, d, f, device=device, generate_mode=True,
                          load_adapter=bool(m.adapter_name_or_path))


@torch.no_grad()
def check_merged(unmerged, reloaded, tok, tag):
    """Every LLM tensor of the reloaded merged export equals the merge of
    the unmerged model's base and adapter (the f32 delta cast to bf16),
    bit for bit; the last-token logits of one prompt agree within
    MERGE_LOGIT_TOL. Returns the relative logit difference."""
    from llamole_tpu_torch.models.gllm.lora import LoRALinear

    got = dict(reloaded.llm.named_parameters())
    base = {n: p for n, p in unmerged.llm.named_parameters()
            if "lora_" not in n}
    if set(got) != set(base):
        fail(f"the merged export holds {sorted(set(got) ^ set(base))[:3]}"
             " beside or in place of the base's tensors")
    mods = dict(unmerged.llm.named_modules())
    bad, n_merged = [], 0
    for name, p in base.items():
        want = p
        owner = mods[name.rsplit(".", 1)[0]]
        if (isinstance(owner, LoRALinear) and owner.lora_a is not None
                and name.endswith("weight")):
            delta = (owner.lora_b.float() @ owner.lora_a.float()) \
                * owner.lora_scale
            want = (p.float() + delta).to(p.dtype)
            n_merged += 1
        if not torch.equal(got[name], want):
            bad.append(name)
    if bad:
        fail(f"merged tensors differ from base + adapter: {bad[:3]}")
    ids = torch.tensor([tok.encode(PROMPT)], device=unmerged.device)
    ref = unmerged.llm(ids, last_logits_only=True)[0][:, -1].float()
    out = reloaded.llm(ids, last_logits_only=True)[0][:, -1].float()
    rel = float((out - ref).abs().max() / ref.abs().max())
    print(f"interchange: {len(got)} LLM tensors of the merged export equal "
          f"base + adapter bit for bit ({n_merged} projections merged); "
          f"last-token logits merged vs unmerged: max |diff| / max |logit| "
          f"{rel:.3e} (limit {MERGE_LOGIT_TOL}) [{tag}]", flush=True)
    if not rel <= MERGE_LOGIT_TOL:
        fail(f"merged logits differ by {rel} > {MERGE_LOGIT_TOL}")
    return rel


def check_msgpack(reloaded, streamed, tag):
    """merge_adapter's model.msgpack, streamed into the byte counter, is
    the msgpack of the reloaded merged export's LLM: the same byte count
    and sha256 (check_merged holds that LLM to base + adapter)."""
    from llamole_tpu_torch.weights import llm_tree

    t0 = time.perf_counter()
    again = _msgpack_to_counter(llm_tree(reloaded.llm))
    again = (again.nbytes, again.sha.hexdigest())
    print(f"interchange: model.msgpack ({streamed[0]} bytes, sha256 "
          f"{streamed[1][:16]}...) equals the msgpack of the reloaded "
          f"merged LLM: {again == streamed} (second stream "
          f"{time.perf_counter() - t0:.3f} s) [{tag}]", flush=True)
    if again != streamed:
        fail(f"model.msgpack {streamed} differs from the reloaded merged "
             f"LLM's {again}")


def serve_interchange(model, tok, kernels, tag, sizes):
    """Phase 12, step 4: requests from the reloaded merged model through
    DesignServer, the first asking for a route. Returns the launches of
    kernels A and B (none on the CPU)."""
    from llamole_tpu_torch.models.composite import GenerationSettings
    from llamole_tpu_torch.serve import DesignServer

    on_card = model.device.type == "cuda"
    timers = PathTimers(model)
    gen = GenerationSettings(max_new_tokens=sizes["max_new_tokens"],
                             temperature=0.6, top_p=0.9, do_sample=True)
    server = DesignServer(model, tok, batch_size=8, max_wait_s=0.5, gen=gen,
                          rollback=True, seed=0,
                          retro_iterations=sizes["retro_iterations"],
                          retro_max_time=sizes["retro_max_time"])
    reset_counts(*kernels)
    t0 = time.perf_counter()
    server.start()
    try:
        handles = [server.submit(f"{PROMPT_HEADER}{i}.",
                                 PROPERTIES[i % len(PROPERTIES)],
                                 retro=(i == 0))
                   for i in range(sizes["requests"])]
        results = [h.result(timeout=900) for h in handles]
    finally:
        server.stop()
    wall = time.perf_counter() - t0
    errors = [r["error"] for r in results if "error" in r]
    if len(results) != sizes["requests"] or errors:
        fail(f"interchange serving: {len(results)} answers, errors "
             f"{errors[:3]}")
    if results[0]["smiles"] is not None and not isinstance(
            results[0].get("retro"), dict):
        fail(f"interchange retro request without a retro block: "
             f"{results[0]}")
    print(f"interchange serving from the reloaded merged export: "
          f"{len(results)} answered in {wall:.3f} s, smiles "
          f"{[r['smiles'] for r in results]}, route found "
          f"{bool(results[0].get('retro', {}).get('success'))} [{tag}]",
          flush=True)
    launches = {"A": 0, "B": 0}
    if on_card:
        fused, gin = kernels[:2]
        launches = {"A": fused.launches, "A_mma": fused.launches_mma,
                    "A_tf32x3": fused.launches_tf32x3,
                    "A_fma": fused.launches_fma, "B": gin.launches}
        # the reloaded GraphDiT is f32: every launch on the split-TF32 body
        check_one_body(fused, "tf32x3", "interchange serving")
        steps = diffusion_steps(model)
        depth = model.graph_decoder.cfg.depth
        batches = timers.count("design")
        check_launches("fused_block_attention (interchange)", launches["A"],
                       depth * steps * batches,
                       f"{depth} x {steps} x {batches}")
        check_launches("gin_aggregate (interchange)", launches["B"],
                       timers.gin_floor(),
                       f"{GIN_LAYERS} x ({timers.count('splice')} rounds + "
                       f"{timers.count('predictor')} products)")
    return launches


def run_interchange(kernels, work, train_dir, tag, device="cuda",
                    sizes=None, then=None):
    """Phase 12, steps 2-6, on an empty card: merge_adapter through its
    normal entry (work/base + phase 9's adapter + the graph modules ->
    work/merged), the unmerged and the merged model built through
    build_graph_lm, their tensors and logits held together, requests
    served from the merged one; then `then()` (phase 17, which reads
    work/base) once the card is empty again. work/base and work/merged
    are deleted whatever happens. Returns the A and B launches of the
    serving."""
    from llamole_tpu_torch.models import loader
    from llamole_tpu_torch.train import export
    from llamole_tpu_torch.train.export import merge_adapter

    sizes = sizes or INTERCHANGE
    on_card = device == "cuda"
    merged = os.path.join(work, "merged")
    log = {}
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        save_pytree, export.save_pytree = export.save_pytree, \
            _msgpack_to_counter
        try:
            with timed_calls(loader, ["load_hf_weights"], log), \
                    timed_calls(export, ["merge_lora", "save_pytree",
                                         "export_hf_weights"], log):
                merge_adapter(_interchange_args(
                    work, adapter_name_or_path=train_dir,
                    export_size=sizes["shard_gb"], export_dir=merged),
                    device=device)
        finally:
            export.save_pytree = save_pytree
        merge_wall = time.perf_counter() - t0
        base_bytes = sum(os.path.getsize(os.path.join(work, "base", f))
                         for f in os.listdir(os.path.join(work, "base"))
                         if f.endswith(".safetensors"))
        out_bytes = sum(os.path.getsize(os.path.join(merged, f))
                        for f in os.listdir(merged)
                        if f.endswith(".safetensors"))
        (imp, _), = log["load_hf_weights"]
        (mrg, n), = log["merge_lora"]
        (pk, msgpack), = log["save_pytree"]
        streamed = (msgpack.nbytes, msgpack.sha.hexdigest())
        (hf, _), = log["export_hf_weights"]
        print(f"interchange merge_adapter: {merge_wall:.3f} s wall; "
              f"safetensors import {base_bytes} bytes in {imp:.3f} s = "
              f"{base_bytes / imp / 1e9:.3f} GB/s, merge_lora {n} "
              f"projections in {mrg:.3f} s, model.msgpack "
              f"{msgpack.nbytes} bytes into the hashing byte counter in "
              f"{pk:.3f} s = {msgpack.nbytes / pk / 1e9:.3f} GB/s, HF export "
              f"{out_bytes} bytes in {hf:.3f} s = {out_bytes / hf / 1e9:.3f}"
              f" GB/s; peak {_peak(on_card)} [{tag}]", flush=True)
        log.clear()     # it holds what the calls returned: the merged LLM
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        unmerged, tok = _build(_interchange_args(
            work, adapter_name_or_path=train_dir), device)
        t1 = time.perf_counter()
        reloaded, tok2 = _build(_interchange_args(
            work, model_name_or_path=merged, adapter_name_or_path=merged,
            finetuning_type="freeze"), device)
        t2 = time.perf_counter()
        print(f"interchange: unmerged model (base + adapter) built in "
              f"{t1 - t0:.3f} s, merged export reloaded in {t2 - t1:.3f} s "
              f"[{tag}]", flush=True)
        rel = check_merged(unmerged, reloaded, tok, tag)
        check_msgpack(reloaded, streamed, tag)
        del unmerged
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        launches = serve_interchange(reloaded, tok2, kernels, tag, sizes)
        print(f"interchange phase: peak {_peak(on_card)} over the two "
              f"models and the serving [{tag}]", flush=True)
        del reloaded, tok2
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        if then is not None:
            then()
    finally:
        for d in ("base", "merged"):
            shutil.rmtree(os.path.join(work, d), ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return launches, rel


# Phase 17, the entry points and tools at the Llama-3.1-8B width, inside
# phase 12 once its merged model is freed: `python -m llamole_tpu_torch
# env`, validate_data, `pretrain oracle` inside profiling.trace(), eval on
# a YAML, parity and the web UI, each through cli.main or the UI server
# from phase 12's files (the 8B base as HF safetensors, phase 9's adapter,
# the graph modules). The eval YAML follows config/generate/llama_drug.yaml
# but for its paths, 64 new tokens and an eval batch of 2; parity runs its
# defaults (template default, 128 new tokens, top-k 50, 100 iterations)
# on 1 record with a 10 s wall per molecule
ENTRY = {"oracle_steps": 20, "eval_records": 2, "eval_batch": 2,
         "max_new_tokens": 64, "cutoff_len": 128, "parity_records": 1,
         "parity_wall": 10.0}
# the keys of parity_table.json: the JAX package's _flatten_table
# (tests/test_torch_parity.py holds them equal)
PARITY_KEYS = ("validity", "retro_success", "acc_BBBP", "acc_HIV",
               "acc_BACE", "mae_CO2", "mae_N2", "mae_O2", "mae_FFV",
               "mae_TC", "mae_SC", "mae_SA", "bleu4", "rouge1", "rouge2",
               "rougeL", "uniqueness", "novelty", "fgd", "num_records",
               "molecules_per_min")
UI_PROPERTIES = {"HIV": 1.0, "SA": 2.5}
UI_KEYS = {"smiles", "valid", "text_html", "reactions_html", "mol_svg",
           "route_svg", "route_found"}


@contextlib.contextmanager
def built_models():
    """Every GraphLM the entry points build inside the block, with
    PathTimers on its stages: a list of (model, timers). The caller
    clears it so the models can go."""
    from llamole_tpu_torch.models import loader

    built, orig = [], loader.build_graph_lm

    def build(*args, **kwargs):
        model, tok = orig(*args, **kwargs)
        built.append((model, PathTimers(model)))
        return model, tok

    loader.build_graph_lm = build
    try:
        yield built
    finally:
        loader.build_graph_lm = orig


def _entry_launches(kernels, on_card):
    if not on_card:
        return {"A": 0, "A_mma": 0, "A_tf32x3": 0, "A_fma": 0, "B": 0,
                "C": 0}
    fused, gin, gin_bwd = kernels[:3]
    return {"A": fused.launches, "A_mma": fused.launches_mma,
            "A_tf32x3": fused.launches_tf32x3, "A_fma": fused.launches_fma,
            "B": gin.launches, "C": gin_bwd.launches}


def check_design_launches(built, launches, what, on_card, tag):
    """Kernel A on every reverse step of every denoiser block of each
    design batch, B on every GIN layer of each expansion round and each
    product scored, in the models built for this part (one expected); on
    the card every A launch on the split-TF32 body (the graph modules load
    in f32)."""
    if len(built) != 1:
        fail(f"{what}: the entry point built {len(built)} models, not 1")
    model, timers = built[0]
    print(f"{what}: fused_block_attention bodies mma {launches['A_mma']}, "
          f"tf32x3 {launches['A_tf32x3']}, fma {launches['A_fma']}; "
          f"{timers.count('design')} design "
          f"batch(es) in {timers.seconds('design'):.3f} s (the sampler "
          f"{timers.seconds('sampler'):.3f} s; the LLM's generate calls, "
          f"design and retro, {timers.seconds('decode'):.3f} s in all), "
          f"{timers.count('rounds')} expansion round(s), "
          f"{timers.count('predictor')} product(s) scored [{tag}]",
          flush=True)
    timers.report_phase2(tag)
    if not on_card:
        return
    if launches["A_tf32x3"] != launches["A"]:
        fail(f"{what}: {launches['A']} kernel-A launches, "
             f"{launches['A_tf32x3']} on the tf32x3 body (mma "
             f"{launches['A_mma']}, fma {launches['A_fma']})")
    steps, depth = diffusion_steps(model), model.graph_decoder.cfg.depth
    batches = timers.count("design")
    check_launches(f"fused_block_attention ({what})", launches["A"],
                   depth * steps * batches, f"{depth} x {steps} x {batches}")
    check_launches(f"gin_aggregate ({what})", launches["B"],
                   timers.gin_floor(),
                   f"{GIN_LAYERS} x ({timers.count('splice')} rounds + "
                   f"{timers.count('predictor')} products)")


def _free(built, on_card):
    built.clear()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def entry_env(device, tag):
    """(a) `python -m llamole_tpu_torch env` in a subprocess from the
    repo root: exit 0 and the device in its default_device line."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "llamole_tpu_torch", "env"]
    if device != "cuda":
        cmd += ["--device", device]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=300)
    want = (f"cuda:0 ({torch.cuda.get_device_name(0)})" if device == "cuda"
            else device)
    lines = dict(line.split(": ", 1) for line in proc.stdout.splitlines()
                 if ": " in line)
    print(f"phase 17 (a) python -m llamole_tpu_torch env: exit "
          f"{proc.returncode}, {lines} [{tag}]", flush=True)
    if proc.returncode != 0 or lines.get("default_device") != want:
        fail(f"env: exit {proc.returncode}, default_device "
             f"{lines.get('default_device')!r} (want {want!r}); "
             f"{proc.stderr[-2000:]}")


def entry_pretrain(kernels, entry, device, tag, sizes):
    """(b) validate_data on the training examples, then `pretrain oracle`
    on them inside profiling.trace(): B and C on every GIN layer of every
    step, no plain GIN call on the card, and a trace that names both
    kernels. Returns the oracle's directory and the launches."""
    from llamole_tpu_torch import cli
    from llamole_tpu_torch.utils import profiling

    on_card = device == "cuda"
    corpus = str(Path(__file__).resolve().parent / "data"
                 / "molqa_train_examples.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["validate_data", corpus])
    report = json.loads(out.getvalue())
    print(f"phase 17 (b) validate_data: ok {report['ok']}, "
          f"{report['records']} records, property coverage "
          f"{report['property_coverage']} [{tag}]", flush=True)
    if not report["ok"]:
        fail(f"validate_data: {report}")
    oracle = os.path.join(entry, "oracle")
    traces = os.path.join(entry, "trace")
    steps = sizes["oracle_steps"]
    reset_counts(*kernels)
    t0 = time.perf_counter()
    with plain_gin_calls(on_card) as plain, profiling.trace(traces):
        cli.main(["pretrain", "oracle", corpus, oracle, f"steps={steps}",
                  "--device", device])
    wall = time.perf_counter() - t0
    launches = _entry_launches(kernels, on_card)
    files = os.listdir(traces)
    if len(files) != 1:
        fail(f"pretrain oracle under trace(): {files} in {traces}")
    path = os.path.join(traces, files[0])
    with open(path) as f:
        names = {str(e.get("name")) for e in json.load(f)["traceEvents"]}
    kernel_names = sorted(n for n in names if "gin_aggregate_kernel" in n
                          or "gin_backward" in n)
    print(f"phase 17 (b) pretrain oracle ({steps} steps) under trace(): "
          f"{wall:.3f} s, trace {os.path.getsize(path)} bytes, "
          f"{len(names)} event names, GIN kernels named {kernel_names}; "
          f"plain GIN calls {plain[0]} [{tag}]", flush=True)
    if on_card:
        from llamole_tpu_torch.models.oracle import PropertyOracleConfig
        layers = PropertyOracleConfig().num_layer
        check_launches("gin_aggregate (pretrain oracle)", launches["B"],
                       layers * steps, f"{layers} layers x {steps} steps")
        check_launches("gin_aggregate_backward (pretrain oracle)",
                       launches["C"], layers * steps,
                       f"{layers} layers x {steps} steps")
        for want in ("gin_aggregate_kernel", "gin_backward"):
            if not any(want in n for n in kernel_names):
                fail(f"the trace names no {want} kernel")
    if not os.path.exists(os.path.join(oracle, "model.msgpack")):
        fail(f"pretrain oracle wrote no model.msgpack under {oracle}")
    return oracle, launches


def _entry_config(work, train_dir, sizes, **extra):
    """config/generate/llama_drug.yaml's settings over phase 12's files."""
    mods = os.path.join(work, "modules")
    return {"model_name_or_path": os.path.join(work, "base"),
            "adapter_name_or_path": train_dir,
            "graph_decoder_path": os.path.join(mods, "graph_decoder"),
            "graph_encoder_path": os.path.join(mods, "graph_encoder"),
            "graph_predictor_path": os.path.join(mods, "graph_predictor"),
            "max_new_tokens": sizes["max_new_tokens"], "temperature": 0.6,
            "top_p": 0.9, "finetuning_type": "lora", "lora_rank": 8,
            "do_train": False, "learned_query_size": 8,
            "template": "llama3", "cutoff_len": sizes["cutoff_len"],
            "bf16": True, "pure_bf16": True, **extra}


def entry_eval(kernels, work, train_dir, entry, device, tag, sizes):
    """(c) `eval <yaml>` on a YAML written here, over a copy of the first
    records of data/molqa_drug_examples.json: the results JSON with its
    summary, no record with an "error", A and B on the path."""
    from llamole_tpu_torch import cli
    from llamole_tpu_torch.utils.flat_yaml import dump_flat_yaml

    on_card = device == "cuda"
    data = os.path.join(entry, "data")
    os.makedirs(data)
    src = Path(__file__).resolve().parent / "data" / "molqa_drug_examples.json"
    with open(src) as f:
        records = json.load(f)[:sizes["eval_records"]]
    with open(os.path.join(data, "molqa_drug_entry.json"), "w") as f:
        json.dump(records, f)
    out = os.path.join(entry, "eval")
    yaml = os.path.join(entry, "eval.yaml")
    with open(yaml, "w") as f:
        f.write(dump_flat_yaml(_entry_config(
            work, train_dir, sizes, dataset="molqa_drug_entry",
            dataset_dir=data, output_dir=out,
            per_device_eval_batch_size=sizes["eval_batch"])))
    reset_counts(*kernels)
    t0 = time.perf_counter()
    with built_models() as built:
        cli.main(["eval", yaml, "--device", device])
        wall = time.perf_counter() - t0
        launches = _entry_launches(kernels, on_card)
        check_design_launches(built, launches, "phase 17 (c) eval", on_card,
                              tag)
        _free(built, on_card)
    with open(os.path.join(out, "molqa_results.json")) as f:
        written = json.load(f)
    summary, results = written["summary"], written["results"]
    print(f"phase 17 (c) eval {yaml}: {wall:.3f} s, summary "
          f"{json.dumps(summary)} [{tag}]", flush=True)
    errors = [r for r in results if "error" in r]
    if summary["num_records"] != len(records) or errors:
        fail(f"eval: {summary['num_records']} records, errors {errors[:2]}")
    return launches


def entry_parity(kernels, work, oracle, entry, device, tag, sizes):
    """(d) `parity` over phase 12's files: converted/ already holds the
    graph modules, so nothing converts; parity_table.json has the JAX
    package's keys and a validity."""
    from llamole_tpu_torch import cli

    on_card = device == "cuda"
    mods = os.path.join(work, "modules")
    out = os.path.join(entry, "parity")
    os.makedirs(os.path.join(out, "converted"))
    for kind, name in (("graphdit", "graph_decoder"),
                       ("encoder", "graph_encoder"),
                       ("predictor", "graph_predictor")):
        os.symlink(os.path.join(mods, name),
                   os.path.join(out, "converted", kind))
    reset_counts(*kernels)
    t0 = time.perf_counter()
    with built_models() as built:
        cli.main(["parity", "--base-llm", os.path.join(work, "base"),
                  "--graphdit", os.path.join(mods, "graph_decoder"),
                  "--encoder", os.path.join(mods, "graph_encoder"),
                  "--predictor", os.path.join(mods, "graph_predictor"),
                  "--oracle", oracle,
                  "--records", str(sizes["parity_records"]),
                  "--max-planning-time", str(sizes["parity_wall"]),
                  "--out", out, "--device", device])
        wall = time.perf_counter() - t0
        launches = _entry_launches(kernels, on_card)
        check_design_launches(built, launches, "phase 17 (d) parity",
                              on_card, tag)
        _free(built, on_card)
    with open(os.path.join(out, "parity_table.json")) as f:
        table = json.load(f)
    print(f"phase 17 (d) parity: {wall:.3f} s, table {json.dumps(table)} "
          f"[{tag}]", flush=True)
    if tuple(table) != PARITY_KEYS or table["validity"] is None:
        fail(f"parity_table.json: keys {list(table)}, validity "
             f"{table.get('validity')}")
    return launches


def _http(port, path, body=None, timeout=900):
    """(status, body bytes) of one request to the UI."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def entry_webui(kernels, work, train_dir, device, tag, sizes):
    """(e) DesignUIServer on 127.0.0.1, port 0, from a config dict naming
    phase 12's files: the page, /health, one design request (the JAX
    package's keys, an SVG when the molecule is valid, A and B on the
    path), a malformed request (500 with an "error") and /health after
    it. The server is shut down whatever happens."""
    from llamole_tpu_torch.webui.server import DesignUIServer, _render_page

    on_card = device == "cuda"
    reset_counts(*kernels)
    with built_models() as built:
        t0 = time.perf_counter()
        ui = DesignUIServer(_entry_config(work, train_dir, sizes),
                            host="127.0.0.1", port=0, device=device)
        build = time.perf_counter() - t0
        design_log = []
        timed(ui, "design", design_log)
        thread = threading.Thread(target=ui.serve_forever, daemon=True)
        thread.start()
        try:
            status, page = _http(ui.port, "/")
            if status != 200 or page.decode() != _render_page():
                fail(f"UI page: status {status}, {len(page)} bytes")
            status, health = _http(ui.port, "/health")
            if status != 200 or not json.loads(health)["ok"]:
                fail(f"UI /health: {status} {health!r}")
            t0 = time.perf_counter()
            status, body = _http(ui.port, "/api/design", json.dumps({
                "instruction": PROMPT,
                "properties": UI_PROPERTIES}).encode())
            latency = time.perf_counter() - t0
            launches = _entry_launches(kernels, on_card)
            out = json.loads(body)
            if status != 200 or set(out) != UI_KEYS:
                fail(f"UI design: status {status}, {out}")
            if out["valid"] and not out["mol_svg"].startswith("<svg"):
                fail(f"UI design: a valid {out['smiles']!r} without an SVG")
            check_design_launches(built, launches, "phase 17 (e) web UI",
                                  on_card, tag)
            status, bad = _http(ui.port, "/api/design", b"{not json")
            if status != 500 or "error" not in json.loads(bad):
                fail(f"UI malformed request: {status} {bad!r}")
            status, _ = _http(ui.port, "/health")
            if status != 200:
                fail(f"UI /health after the malformed request: {status}")
        finally:
            ui.shutdown()
            thread.join(timeout=60)
        (design_wall, _), = design_log
        print(f"phase 17 (e) web UI: built in {build:.3f} s; design "
              f"request {latency:.3f} s (the design itself {design_wall:.3f}"
              f" s), smiles {out['smiles']!r}, valid {out['valid']}, route "
              f"found {out['route_found']}, SVG {len(out['mol_svg'])} "
              f"bytes; malformed request 500: {json.loads(bad)} [{tag}]",
              flush=True)
        if thread.is_alive():
            fail("the UI server's thread outlived shutdown")
        del ui
        _free(built, on_card)
    return launches


def run_entry_points(kernels, work, train_dir, tag, device="cuda",
                     sizes=None):
    """Phase 17 (ENTRY): (a)-(e) above, each timed by the host clock and
    its kernel counts set to 0 before and read after it. Returns the
    launches of A (per body), B and C summed over the parts."""
    sizes = sizes or ENTRY
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    entry = os.path.join(work, "entry")
    os.makedirs(entry)
    walls, parts = {}, []

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[name] = round(time.perf_counter() - t0, 3)
        return out

    timed("(a) env", lambda: entry_env(device, tag))
    oracle, got = timed("(b) validate_data + pretrain oracle",
                        lambda: entry_pretrain(kernels, entry, device, tag,
                                               sizes))
    parts.append(got)
    parts.append(timed("(c) eval", lambda: entry_eval(
        kernels, work, train_dir, entry, device, tag, sizes)))
    parts.append(timed("(d) parity", lambda: entry_parity(
        kernels, work, oracle, entry, device, tag, sizes)))
    parts.append(timed("(e) web UI", lambda: entry_webui(
        kernels, work, train_dir, device, tag, sizes)))
    total = {k: sum(p[k] for p in parts) for k in parts[0]}
    print(f"phase 17 (entry points): {sum(walls.values()):.1f} s; parts "
          f"{json.dumps(walls)}; launches {total}; peak {_peak(on_card)} "
          f"[{tag}]", flush=True)
    return total


def _peak(on_card) -> str:
    return (f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB "
            "(torch.cuda.max_memory_allocated)" if on_card
            else "not measured (CPU)")


# Phase 14, quantized serving at the slice's Llama-3.1-8B shape on an
# emptied card, as bench.py's molqa cell builds it: the LLM drawn straight
# into int8 weights (quantize.init_quantized_) with the int8 KV cache,
# GraphDiT / GraphCLIP / the predictor as in phase 7, phase 7's first 4
# requests (the first asking for a route) through DesignServer with phase
# 7's generation and retro settings; then the three schemes, the int8 KV
# cache, LoRA over the int8 base through run_mmsft and the int8 denoiser
# (b)'s LLM runs 24 of the 32 layers (since phase 16 joined, to keep the
# script in its time limit; its bytes stay under BYTES_BOUNDS there: int8
# 0.542x, int4 0.327x of the bf16 LLM's); (a)'s runs all 32
QUANTIZED = {"requests": 4, "max_new_tokens": 128, "retro_iterations": 100,
             "retro_max_time": 30.0, "prefill_batch": 8, "decode_tokens": 32,
             "train_steps": 2, "design_batch": 8, "scheme_layers": 24,
             "serving_layers": 32}
# Bounds, from the CPU tests of the same scheme: int8 0.05, W8A8 0.10 and
# int4 0.15 (tests/test_quantize.py's bounds for the three schemes), the
# int8 KV cache 0.02 (tests/test_llm.py's one-step logit fidelity), the
# int8 denoiser 0.05 (tests/test_graphdit.py), as relative errors. A
# scheme's bound holds for each quantized projection of the first and
# last layers and the head, on the bf16 model's own activations of the
# prefill; the KV cache's for the first layer's attention output at a
# decode step (the two runs' inputs there are equal, only the caches
# differ); both as ||quantized - bf16|| / ||bf16|| over the whole output
# (a max over one output's entries swings with its few largest ones).
# The denoiser's is max |int8 - bf16| over max |bf16|, the JAX test's. A
# random 32-layer stack carries each projection's error to the logits
# several times over (PERF.md), so the logits' errors are printed beside.
QUANT_BOUNDS = {"int8": 0.05, "w8a8": 0.10, "int4": 0.15}
KV_BOUND = 0.02
DENOISER_BOUND = 0.05
# the quantized LLM's weight bytes over the bf16 LLM's (16.06 GB at 8B)
BYTES_BOUNDS = {"int8": 0.55, "w8a8": 0.55, "int4": 0.35}
SCHEME_ARGS = {"int8": (8, False), "w8a8": (8, True), "int4": (4, False)}
QLORA_DEVIATIONS = {
    "quantization_bit": "8: the LoRA and the connectors train over the "
                        "int8 base",
    "max_steps": "2 micro steps",
    "gradient_accumulation_steps": "1, so that the second micro step is an "
                                   "update with a learning rate above 0 (the "
                                   "first, in warmup, has lr 0)",
}


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-12))


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over every entry."""
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-12))


def quantized_llm(cfg, device, bits=8, act_int8=False, seed=0):
    """cfg's LLM in bf16 drawn straight into the quantized layout (no bf16
    tree), with the int8 KV cache."""
    from llamole_tpu_torch.models.gllm import LLM
    from llamole_tpu_torch.models.gllm.quantize import (
        init_quantized_, llm_quant, quant_scheme)

    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    llm = LLM(cfg, torch.bfloat16, device,
              quant=llm_quant(quant_scheme(bits, act_int8), 128))
    return init_quantized_(llm, torch.Generator(device=device)
                           .manual_seed(seed), bits=bits,
                           act_int8=act_int8)


def check_bytes(llm, scheme, tag) -> int:
    """The LLM's weight bytes against the bf16 LLM's of its config
    (counted on the meta device), held to BYTES_BOUNDS."""
    from llamole_tpu_torch.models.gllm import LLM
    from llamole_tpu_torch.models.gllm.quantize import quantized_bytes

    got = quantized_bytes(llm)
    dense = quantized_bytes(LLM(llm.cfg, torch.bfloat16, "meta"))
    print(f"quantized LLM ({scheme}): {got} weight bytes against the bf16 "
          f"LLM's {dense} ({got / dense:.4f}x; bound "
          f"{BYTES_BOUNDS[scheme]}x) [{tag}]", flush=True)
    if not got < BYTES_BOUNDS[scheme] * dense:
        fail(f"{scheme} LLM holds {got} bytes, not below "
             f"{BYTES_BOUNDS[scheme]} x {dense}")
    return got


def serve_quantized(model, tok, kernels, tag, sizes, phase7,
                    what="quantized serving (int8 weights, int8 KV cache)"):
    """Phase 14 (a): the requests through DesignServer on the quantized
    slice (phase 15 (b): on the gemma-2 slice, `what` naming it). Returns
    the A and B launches (on the card)."""
    from llamole_tpu_torch.models.composite import GenerationSettings
    from llamole_tpu_torch.serve import DesignServer

    on_card = model.device.type == "cuda"
    timers = PathTimers(model)
    gen = GenerationSettings(max_new_tokens=sizes["max_new_tokens"],
                             temperature=0.6, top_p=0.9, do_sample=True)
    server = DesignServer(model, tok, batch_size=8, max_wait_s=0.5, gen=gen,
                          rollback=True, seed=0,
                          retro_iterations=sizes["retro_iterations"],
                          retro_max_time=sizes["retro_max_time"])
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    server.start()
    try:
        handles = [server.submit(f"{PROMPT_HEADER}{i}.",
                                 PROPERTIES[i % len(PROPERTIES)],
                                 retro=(i == 0))
                   for i in range(sizes["requests"])]
        results = [h.result(timeout=900) for h in handles]
    finally:
        server.stop()
    wall = time.perf_counter() - t0
    errors = [r["error"] for r in results if "error" in r]
    if len(results) != sizes["requests"] or errors:
        fail(f"{what}: {len(results)} answers, errors {errors[:3]}")
    if results[0]["smiles"] is not None and not isinstance(
            results[0].get("retro"), dict):
        fail(f"{what}: retro request without a retro block: {results[0]}")
    pad = tok.pad_token_id
    decodes = timers.log["decode"]
    dec_tokens = sum(int((out[0] != pad).sum()) for _, out in decodes)
    rate = dec_tokens / timers.seconds("decode")
    valid = sum(model.graph_decoder.check_valid(r["smiles"])
                for r in results)
    beside = (f"; phase 7 (bf16 weights, compute-dtype cache) "
              f"{phase7['decode_tok_s']:.1f} tok/s in this run"
              if phase7 else "")
    print(f"{what}: "
          f"{len(results)} answered in {wall:.3f} s, valid SMILES {valid}, "
          f"route found {bool(results[0].get('retro', {}).get('success'))};"
          f" decode {dec_tokens} tokens in {timers.seconds('decode'):.3f} s"
          f" = {rate:.1f} tok/s{beside}; latency (s) retro request "
          f"{results[0]['latency_s']:.3f}, design-only "
          f"{[round(r['latency_s'], 3) for r in results[1:]]}; design "
          f"batch walls {[round(t, 3) for t, _ in timers.log['design']]} s;"
          f" peak {_peak(on_card)} [{tag}]", flush=True)
    launches = {"A": 0, "A_mma": 0, "A_fma": 0, "B": 0}
    if on_card:
        fused, gin = kernels[:2]
        launches = {"A": fused.launches, "A_mma": fused.launches_mma,
                    "A_fma": fused.launches_fma, "B": gin.launches}
        check_one_body(fused, "mma", what)
        steps = diffusion_steps(model)
        depth = model.graph_decoder.cfg.depth
        batches = timers.count("design")
        check_launches(f"fused_block_attention ({what})",
                       launches["A"], depth * steps * batches,
                       f"{depth} x {steps} x {batches}")
        check_launches(f"gin_aggregate ({what})", launches["B"],
                       timers.gin_floor(),
                       f"{GIN_LAYERS} x ({timers.count('splice')} rounds + "
                       f"{timers.count('predictor')} products)")
    return launches


@torch.no_grad()
def decode_split(llm, tok, tag, sizes):
    """Phase 14 (a), after serving: ms per greedy decode step of the
    serving LLM (int8 weights, rank-8 LoRA) at batch 8 with its int8 KV
    cache and with a compute-dtype one, each with the adapter on and off,
    then one profiled run (int8 cache, adapter on): the device's busy
    share of the wall, aten ops a step and the 5 costliest kernels. Splits
    the serving decode's cost between the weights, the cache and the
    adapter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llamole_tpu_torch.models.gllm.lora import adapters_off

    steps = sizes["decode_tokens"]
    ids, mask = _prompt_batch(tok, sizes["prefill_batch"], llm.device)
    base = llm.cfg
    adapted = [m for m in llm.modules() if getattr(m, "lora_a", None)
               is not None]
    ms = {}
    llm.generate(ids, mask, max_new_tokens=2, do_sample=False,
                 spec_tokens=0)   # warm
    try:
        for kv in ("int8", "compute"):
            llm.cfg = dataclasses.replace(base, kv_cache_dtype=kv)
            for adapter in (True, False):
                with (contextlib.nullcontext() if adapter
                      else adapters_off(adapted)):
                    ms[(kv, adapter)] = _timed_generate(llm, ids, mask,
                                                        steps)[1]
    finally:
        llm.cfg = base
    on_card = llm.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    _sync_card()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        llm.generate(ids, mask, max_new_tokens=steps, do_sample=False,
                     spec_tokens=0)
        _sync_card()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    ops = sum(e.count for e in events if e.key.startswith("aten::"))
    kernels = sorted((e for e in events
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in kernels) / 1e3
    top = [(e.key[:40], round(e.device_time_total / 1e3, 2))
           for e in kernels[:5]]
    device = (f"device busy {busy:.1f} of {1e3 * wall:.1f} ms wall over "
              f"{sum(e.count for e in kernels)} kernel launches, top "
              f"kernels (ms) {top}" if on_card
              else "device time not measured (CPU)")
    print(f"serving LLM decode, ms a greedy step at batch {ids.shape[0]}: "
          + ", ".join(f"{kv} cache, adapter {'on' if a else 'off'} "
                      f"{v:.3f}" for (kv, a), v in ms.items())
          + f"; profiled (int8 cache, adapter on, {steps} steps): "
          f"{ops / (steps + 1):.0f} aten calls (nested ones included) a "
          f"forward, {device} [{tag}]", flush=True)
    return ms


@torch.no_grad()
def check_int8_denoiser(model, kernels, tag, sizes):
    """Phase 14 (e): quantize_denoiser_params on a copy of the slice's
    GraphDiT denoiser: one forward against the bf16 one within
    DENOISER_BOUND, a design batch at the full reverse steps on it (valid
    SMILES; on the card kernel A all on the mma body) and the ms per
    reverse step of both. Returns A's launches (on the card)."""
    from llamole_tpu_torch.models.graphdit.denoiser import (
        quantize_denoiser_params)

    dit = model.graph_decoder
    cfg = dit.cfg
    dense = dit.denoiser
    dev = model.device
    int8 = quantize_denoiser_params(copy.deepcopy(dense))
    b, n = sizes["design_batch"], cfg.max_n_nodes
    g = torch.Generator().manual_seed(0)
    X = torch.eye(cfg.Xdim)[torch.randint(0, cfg.Xdim, (b, n), generator=g)]
    E = torch.eye(cfg.Edim)[torch.randint(0, cfg.Edim, (b, n, n),
                                          generator=g)]
    mask = torch.arange(n)[None] < torch.randint(8, n + 1, (b, 1),
                                                 generator=g)
    y = torch.full((b, cfg.ydim), float("nan"))
    txt = torch.randn(b, cfg.text_dim, generator=g)
    inputs = [a.to(dev) for a in (X, E, mask, y, txt, torch.full((b,), .5))]
    rels = [_rel(q, d) for q, d in zip(int8(*inputs), dense(*inputs))]
    print(f"int8 denoiser ({cfg.hidden_size} x {cfg.depth}) against bf16: "
          f"max rel err atoms {rels[0]:.4e}, bonds {rels[1]:.4e} (bound "
          f"{DENOISER_BOUND}) [{tag}]", flush=True)
    if not max(rels) < DENOISER_BOUND:
        fail(f"int8 denoiser off the bf16 one by {max(rels)}")
    props = torch.full((b, cfg.ydim), float("nan"), device=dev)
    text = torch.randn(b, cfg.text_dim, generator=g).to(dev)
    steps = diffusion_steps(model)
    step_ms, launches = {}, {"A": 0, "A_mma": 0, "A_fma": 0}
    try:
        for name, den in (("bf16", dense), ("int8", int8)):
            dit.denoiser = den
            reset_counts(*kernels)
            _sync_card()
            t0 = time.perf_counter()
            smiles = dit.generate(torch.Generator(device=dev).manual_seed(1),
                                  props, text)
            _sync_card()
            step_ms[name] = 1e3 * (time.perf_counter() - t0) / steps
    finally:
        dit.denoiser = dense
    valid = sum(dit.check_valid(s) for s in smiles)
    if dev.type == "cuda":
        fused = kernels[0]
        launches = {"A": fused.launches, "A_mma": fused.launches_mma,
                    "A_fma": fused.launches_fma}
        check_one_body(fused, "mma", "int8 denoiser")
        check_launches("fused_block_attention (int8 denoiser)",
                       fused.launches, cfg.depth * steps,
                       f"{cfg.depth} x {steps}")
    print(f"int8 denoiser design batch of {b} at {steps} steps: valid "
          f"SMILES {valid} of {b}; ms per reverse step (the batch, "
          f"CFG-doubled, with the host's assembly) int8 "
          f"{step_ms['int8']:.2f}, bf16 {step_ms['bf16']:.2f} in the same "
          f"run [{tag}]", flush=True)
    return launches


def _prompt_batch(tok, rows, device):
    """`rows` PROMPT_HEADER prompts, left-padded (ids, int32 mask)."""
    seqs = [tok.encode(f"{PROMPT_HEADER}{i}.") for i in range(rows)]
    width = max(map(len, seqs))
    ids = [[tok.pad_token_id] * (width - len(s)) + s for s in seqs]
    mask = [[0] * (width - len(s)) + [1] * len(s) for s in seqs]
    return (torch.tensor(ids, device=device),
            torch.tensor(mask, device=device, dtype=torch.int32))


def _record_projections(llm):
    """Forward hooks on the first and last layers' projections and the
    head, each call's (name, input, output) appended to a list."""
    mods = {f"layers.{i}.{group}.{k}": m
            for i in (0, len(llm.layers) - 1)
            for group in ("attn", "mlp")
            for k, m in getattr(llm.layers[i], group).items()}
    if llm.lm_head is not None:
        mods["lm_head"] = llm.lm_head
    seen = []
    handles = [m.register_forward_hook(
        lambda mod, inp, out, name=name: seen.append(
            (name, inp[0].detach().clone(), out.detach().clone())))
        for name, m in mods.items()]
    return seen, handles


def _timed_generate(llm, ids, mask, steps):
    """(tokens, ms per decode step): a greedy generate's wall less a
    prefill's, over its decode steps, between syncs of the card."""
    _sync_card()
    t0 = time.perf_counter()
    llm(input_ids=ids, attention_mask=mask, last_logits_only=True)
    _sync_card()
    t1 = time.perf_counter()
    out, _ = llm.generate(ids, mask, max_new_tokens=steps, do_sample=False,
                          spec_tokens=0)
    _sync_card()
    t2 = time.perf_counter()
    return out, 1e3 * ((t2 - t1) - (t1 - t0)) / steps


@torch.no_grad()
def check_decode_graphs(llm, tok, tag, steps=32, rows=8):
    """generate's per-token decode replayed as a CUDA graph
    (LLM._decode_graph) against the eager loop, on the slice's LLM
    (Llama-3.1-8B, 32 layers, the rank-8 adapter on) and `rows` prompts:
    greedy and sampled tokens (one seed) equal bit for bit, the graph
    replayed, and ms per decode step each way. Returns that record."""
    from llamole_tpu_torch.models.gllm import LLM

    ids, mask = _prompt_batch(tok, rows, llm.device)
    runs = {}
    try:
        for graphs in (False, True):
            llm.decode_graphs = graphs
            llm.generate(ids, mask, max_new_tokens=2, do_sample=False,
                         spec_tokens=0)   # warm
            before = LLM.graph_replays
            greedy, ms = _timed_generate(llm, ids, mask, steps)
            sampled, _ = llm.generate(
                ids, mask, max_new_tokens=steps, temperature=0.6, top_p=0.9,
                generator=torch.Generator(device=llm.device).manual_seed(0))
            runs[graphs] = (greedy, sampled, ms, LLM.graph_replays - before)
    finally:
        del llm.decode_graphs   # the class default: graphs on
    (g0, s0, eager_ms, _), (g1, s1, graph_ms, replays) = runs[False], \
        runs[True]
    same = bool(torch.equal(g0, g1)) and bool(torch.equal(s0, s1))
    print(f"decode graphs: {steps} steps at batch {rows}, greedy and "
          f"sampled tokens equal to the eager loop's: {same}; {replays} "
          f"replays; ms a decode step eager {eager_ms:.3f}, graph "
          f"{graph_ms:.3f} ({eager_ms / graph_ms:.2f}x) [{tag}]", flush=True)
    if runs[False][3] != 0 or replays < 2 * (steps - 1):
        fail(f"decode graphs: {runs[False][3]} replays with graphs off, "
             f"{replays} with them on (want >= {2 * (steps - 1)})")
    if not same:
        diff = (g0 != g1).float().argmax(-1).tolist()
        fail(f"decode graphs: tokens differ from the eager loop's (greedy "
             f"first differences per row {diff})")
    return {"eager_ms": eager_ms, "graph_ms": graph_ms, "replays": replays}


@torch.no_grad()
def check_int_mm(device, cfg, tag):
    """torch._int_mm (through int8_matmul) at the decode's shapes equals
    the exact integer product (f64 sums of these products are exact)."""
    from llamole_tpu_torch.ops.nn import int8_matmul

    g = torch.Generator(device=device).manual_seed(0)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    shapes = ((8, h, inter), (8, inter, h), (8, h, cfg.vocab_size))
    for m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), generator=g, device=device,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=g, device=device,
                          dtype=torch.int8)
        got = int8_matmul(a, b.t())
        if got.dtype != torch.int32 or not torch.equal(
                got.double(), a.double() @ b.double().t()):
            fail(f"torch._int_mm at ({m}, {k}, {n}) is not the exact "
                 "integer product")
    print(f"torch._int_mm exact at (rows, K, N) = {list(shapes)} [{tag}]",
          flush=True)


@torch.no_grad()
def check_kv_cache(llm, ids, mask, steps, tag):
    """Phase 14 (c): one decode step's logits with the int8 cache against
    the compute-dtype cache on the same weights (the first layer's
    attention output there held to KV_BOUND), and the greedy agreement
    over `steps` tokens. Returns (logit rel err, layer-0 rel err,
    agreement)."""
    from llamole_tpu_torch.models.gllm.model import make_kv_cache

    base = llm.cfg
    b, p = ids.shape
    positions = (mask.cumsum(-1) - 1).clamp_min(0)
    kv_valid = torch.cat([mask > 0, torch.ones((b, 1), dtype=torch.bool,
                                               device=ids.device)], 1)
    logits, attn, tokens = {}, {}, {}
    o_proj = llm.layers[0].attn["o"]
    try:
        for kv in ("compute", "int8"):
            llm.cfg = dataclasses.replace(base, kv_cache_dtype=kv)
            cache = make_kv_cache(llm.cfg, b, p + 1, llm.dtype, ids.device)
            first, _, _ = llm(input_ids=ids, attention_mask=mask,
                              positions=positions, kv_cache=cache,
                              cache_index=0, kv_valid=kv_valid,
                              last_logits_only=True)
            if kv == "compute":     # both decode the compute cache's pick
                step_tok = first[:, -1].argmax(-1)[:, None]
            seen = []
            hook = o_proj.register_forward_hook(
                lambda m, inp, out: seen.append(inp[0].clone()))
            try:
                step, _, _ = llm(input_ids=step_tok,
                                 positions=positions[:, -1:] + 1,
                                 kv_cache=cache, cache_index=p,
                                 kv_valid=kv_valid)
            finally:
                hook.remove()
            if cache[0]["k"].dtype != (torch.int8 if kv == "int8"
                                       else llm.dtype):
                fail(f"the {kv} KV cache holds {cache[0]['k'].dtype}")
            logits[kv], attn[kv] = step[:, -1], seen[0]
            tokens[kv], _ = llm.generate(ids, mask, max_new_tokens=steps,
                                         do_sample=False, spec_tokens=0)
    finally:
        llm.cfg = base
    rel = _rel(logits["int8"], logits["compute"])
    layer0 = _rel_l2(attn["int8"], attn["compute"])
    agree = float((tokens["int8"] == tokens["compute"]).float().mean())
    print(f"int8 KV cache against the compute-dtype cache (bf16 weights): "
          f"one decode step's logits max rel err {rel:.4e}; the first "
          f"layer's attention output rel err (l2) {layer0:.4e} (bound "
          f"{KV_BOUND}); "
          f"greedy agreement over {steps} tokens x {b} rows {agree:.4f} "
          f"[{tag}]", flush=True)
    if not layer0 < KV_BOUND:
        fail(f"int8 KV cache: the first layer's attention off by {layer0}")
    return {"logits": rel, "layer0": layer0, "agreement": agree}


@torch.no_grad()
def run_schemes(cfg, tok, device, sizes, tag, phase21=None):
    """Phase 14 (b) and (c): a bf16 LLM of cfg from seed 0, whose prefill
    of a batch of PROMPT_HEADER prompts records the bf16 projections of
    the first and last layers and the head, its last-position logits and
    its greedy decode time; the int8 KV cache is checked on it (c). Then
    per scheme the same LLM, rebuilt from the seed and quantized in place:
    bytes, each recorded projection on its recorded input (QUANT_BOUNDS),
    the prefill's last-position logits (max rel err, top-1 agreement) and
    ms per greedy decode step; every W8A8 projection runs torch._int_mm.
    With phase21, the int4 and W8A8 LLMs are then placed on the mesh
    (phase 21 (a): check_placed_scheme). Returns {scheme: record}."""
    from llamole_tpu_torch.models.gllm import LLM
    from llamole_tpu_torch.models.gllm.quantize import quantize_llm_params
    from llamole_tpu_torch.ops.nn import int8_matmul

    def dense():
        llm = LLM(cfg, torch.bfloat16, device)
        llm.reset_parameters(torch.Generator(device=device).manual_seed(0))
        return llm

    steps = sizes["decode_tokens"]
    ids, mask = _prompt_batch(tok, sizes["prefill_batch"], device)
    llm = dense()
    seen, handles = _record_projections(llm)
    ref, _, _ = llm(input_ids=ids, attention_mask=mask,
                    last_logits_only=True)
    for h in handles:
        h.remove()
    ref = ref[:, -1]
    _, ref_ms = _timed_generate(llm, ids, mask, steps)
    print(f"bf16 LLM: greedy decode {ref_ms:.3f} ms a step (batch "
          f"{ids.shape[0]}, prompt {ids.shape[1]}) [{tag}]", flush=True)
    out = {"bf16": {"ms": ref_ms},
           "kv": check_kv_cache(llm, ids, mask, steps, tag)}
    del llm
    n_proj = 7 * cfg.num_layers + (0 if cfg.tie_word_embeddings else 1)
    for scheme, (bits, a8) in SCHEME_ARGS.items():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        llm = quantize_llm_params(dense(), bits=bits, act_int8=a8)
        nbytes = check_bytes(llm, scheme, tag)
        modules = dict(llm.named_modules())
        proj = max(_rel_l2(modules[name](x), y) for name, x, y in seen)
        logits, _, _ = llm(input_ids=ids, attention_mask=mask,
                           last_logits_only=True)
        rel = _rel(logits[:, -1], ref)
        rel2 = _rel_l2(logits[:, -1], ref)
        top1 = float((logits[:, -1].argmax(-1) == ref.argmax(-1)).float()
                     .mean())
        int8_matmul.launches = 0
        _, ms = _timed_generate(llm, ids, mask, steps)
        int_mm = int8_matmul.launches
        print(f"{scheme}: the quantized projections of the first and last "
              f"layers and the head on the bf16 activations, largest rel "
              f"err (l2) {proj:.4e} (bound {QUANT_BOUNDS[scheme]}); the "
              f"prefill's last-position logits max rel err {rel:.4e}, rel "
              f"err (l2) {rel2:.4e}, top-1 "
              f"agreement {top1:.3f} over {ids.shape[0]} rows; greedy "
              f"decode {ms:.3f} ms a step against bf16's {ref_ms:.3f}; "
              f"torch._int_mm calls {int_mm} [{tag}]", flush=True)
        if not proj < QUANT_BOUNDS[scheme]:
            fail(f"{scheme} projections off the bf16 ones by {proj}")
        # a timed prefill, then generate's prefill and `steps` decodes
        want_mm = n_proj * (2 + steps) if scheme == "w8a8" else 0
        if int_mm != want_mm:
            fail(f"{scheme}: {int_mm} torch._int_mm calls, expected "
                 f"{want_mm}")
        out[scheme] = {"bytes": nbytes, "proj": proj, "logits": rel,
                       "logits_l2": rel2, "top1": top1, "ms": ms}
        if phase21 is not None and scheme in ("int4", "w8a8"):
            phase21["a"][scheme] = check_placed_scheme(
                llm, ids, mask, logits[:, -1], scheme, tag, device,
                phase21.get("sizes"))
        del llm, modules, logits
    gc.collect()
    return out


def llama_lora_dict(out_dir):
    """llama_lora_args' settings as the dict get_train_args reads,
    llama_lora.yaml's method and precision keys included."""
    args = {k: v for g in llama_lora_args(out_dir) for k, v in vars(g).items()}
    args.update(stage="mmsft", do_train=True, lora_target="all", bf16=True,
                pure_bf16=True)
    return args


def qlora_args(out_dir, sizes):
    """llama_lora_args' settings with QLORA_DEVIATIONS, as the dict
    get_train_args reads (llama_lora.yaml's method and precision keys
    included)."""
    args = llama_lora_dict(out_dir)
    args.update(quantization_bit=8, gradient_accumulation_steps=1,
                max_steps=sizes["train_steps"])
    args.update({k: sizes[k] for k in ("model_name_or_path",) if k in sizes})
    return args


def run_qlora(kernels, tag, out_dir, sizes, device, phase9_peak=None,
              phase21=None):
    """Phase 14 (d): the loader builds the GraphLM with quantization_bit=8
    (the LLM drawn in bf16 from the seed, then quantized in place) and
    run_mmsft trains it with phase 9's settings and QLORA_DEVIATIONS:
    finite losses, the LoRA and the connectors changed, the int8 base's
    checksum unchanged; the training peak beside phase 9's. With
    phase21, then phase 21 (a)'s run of the same at ZeRO-3 on the mesh
    (run_qlora_zero3). Returns the B and C launches of run_mmsft (on the
    card)."""
    from llamole_tpu_torch.config import get_train_args
    from llamole_tpu_torch.models.loader import build_graph_lm
    from llamole_tpu_torch.train.workflow import run_mmsft

    raw = qlora_args(out_dir, sizes)
    args = get_train_args(raw)
    m_args, d_args, t_args, f_args, _ = args
    model, tok = build_graph_lm(m_args, d_args, f_args, device=device,
                                seed=t_args.seed)
    if model.llm.quant != ("int8", 0):
        fail(f"run_mmsft's LLM is {model.llm.quant}, not int8")
    base = [t for n, t in (*model.llm.named_parameters(),
                           *model.llm.named_buffers()) if "lora_" not in n]
    base_sum = _checksum(base)
    params = model.trainable_parameters()
    start = _snapshot(params)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    t0 = time.perf_counter()
    metrics = run_mmsft(*args, prebuilt=(model, tok))
    wall = time.perf_counter() - t0
    peak = _peak(device == "cuda")
    launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                if device == "cuda" else {"B": 0, "C": 0})
    with open(Path(out_dir) / "trainer_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    if metrics["train_steps"] != sizes["train_steps"] or len(log) != \
            sizes["train_steps"]:
        fail(f"QLoRA: {metrics['train_steps']} micro steps")
    for rec in log:
        if not all(np.isfinite([rec[k] for k in ("loss", "lm_loss",
                                                  "design_loss",
                                                  "retro_loss")])):
            fail(f"QLoRA: non-finite loss in {rec}")
    changed = {g: any(not torch.equal(params[n], start[n]) for n in params
                      if key in n)
               for g, key in (("LoRA", "lora_"), ("connectors",
                                                  "connectors."))}
    if not all(changed.values()):
        fail(f"QLoRA: unchanged after training: {changed}")
    if _checksum(base) != base_sum:
        fail("QLoRA: the int8 base changed in training")
    beside = (f" against phase 9's {phase9_peak} (bf16 base) in this run"
              if phase9_peak else "")
    print(f"QLoRA (run_mmsft over the int8 base; {QLORA_DEVIATIONS}): "
          f"{len(log)} micro steps in {wall:.3f} s wall, losses "
          f"{[round(r['loss'], 4) for r in log]}, the LoRA and the "
          f"connectors changed, the int8 base's checksum {base_sum} "
          f"unchanged; B {launches['B']} and C {launches['C']} launches; "
          f"peak {peak}{beside} [{tag}]", flush=True)
    del base     # the int8 base's old buffers go when ZeRO-3 cuts them
    if phase21 is not None:
        phase21["a"]["qlora"] = run_qlora_zero3(
            model, tok, raw, start, [r["loss"] for r in log], kernels, tag,
            device, phase21.get("sizes"))
    return launches


def run_quantized(kernels, tag, device="cuda", sizes=None, build=None,
                  llm_cfg=None, phase7=None, phase9_peak=None, phase21=None):
    """Phase 14 on an empty card: (a) quantized serving and (e) the int8
    denoiser on one slice, then (b) the three schemes with (c) the int8
    KV cache, and (d) QLoRA through run_mmsft. build(llm) makes the slice
    around a prebuilt LLM (build_slice by default); llm_cfg is the LLM's
    config (Llama-3.1-8B's by default). With phase21 (a dict), phase 21
    (a) runs on the slice, the schemes and the QLoRA model, its records
    into phase21["a"]. Returns the A launches of (a) and (e), the B
    launches of (a) and (d) and the C launches of (d), and the schemes'
    records."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.loader import offline_tokenizer

    sizes = sizes or QUANTIZED
    build = build or build_slice
    llm_cfg = llm_cfg or LLMConfig.llama3_8b()
    on_card = device == "cuda"
    t0 = time.perf_counter()
    model, tok = build(quantized_llm(dataclasses.replace(
        llm_cfg, num_layers=sizes["serving_layers"]), device))
    check_bytes(model.llm, "int8", tag)
    print(f"quantized slice built (int8 weights drawn on the {device}, "
          f"{sizes['serving_layers']} of {llm_cfg.num_layers} layers) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    served = serve_quantized(model, tok, kernels, tag, sizes, phase7)
    decode_split(model.llm, tok, tag, sizes)
    denoiser = check_int8_denoiser(model, kernels, tag, sizes)
    if phase21 is not None:
        phase21["a"] = {"molqa": run_quant_molqa(model, tok, kernels, tag,
                                                 device, phase21.get("sizes"))}
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check_int_mm(device, llm_cfg, tag)
    schemes = run_schemes(
        dataclasses.replace(llm_cfg, num_layers=sizes["scheme_layers"]),
        offline_tokenizer(), device, sizes, tag, phase21)
    if on_card:
        torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_qlora_")
    try:
        qlora = run_qlora(kernels, tag, work, sizes, device, phase9_peak,
                          phase21)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    launches = {k: served[k] + denoiser.get(k, 0) + qlora.get(k, 0)
                for k in ("A", "A_mma", "A_fma", "B")}
    launches["C"] = qlora["C"]
    return launches, schemes


# Phase 15, the LLM's other families at full width on an emptied card, in
# bf16 with random weights from seed 0: (a) qwen3_8b, its cache against its
# forward and 128 greedy tokens without and with drafts (K = 2), on the
# compute-dtype and the int8 KV cache; (b) gemma2_9b serving phase 7's
# first 4 requests through DesignServer over phase 7's graph modules; (c)
# gemma3_12b on a 1280-token prompt, its cache against its forward across
# the 1024-token window and 32 greedy steps with drafts off; (d) Mixtral at
# full width (4096 / 14336, 8 experts, top-2), 8 of its 32 layers (46.7B
# parameters take 93 GB in bf16, and no expert is quantized): the cache
# against the forward, 64 greedy tokens without and with drafts, the
# capacity drops, one loss and backward at batch 2 with the router term.
# Since phase 16 joined (the script's time limit) qwen3 runs 4 of
# its 36 layers and gemma-3 6 of 48 (5 of them windowed), at full width;
# gemma-2 runs all 42 (21 local, 21 global)
FAMILIES = {"prompts": 8, "greedy_tokens": 128, "spec_tokens": 2,
            "requests": 4, "max_new_tokens": 128, "retro_iterations": 100,
            "retro_max_time": 30.0, "long_prompt": 1280,
            "long_prefill": 1024, "long_steps": 32, "moe_layers": 8,
            "moe_tokens": 64, "train_batch": 2, "qwen3_layers": 4,
            "gemma3_layers": 6, "gemma2_layers": 42}
# The cache-against-forward tolerance: max |cached - forward| over max
# |forward| of the logits at every teacher-forced slot, in bf16: phase 12's
# bound for two bf16 computations of the same logits (MERGE_LOGIT_TOL).
# The greedy paths with and without drafts may part only where the
# per-token path's top-2 logit gap is at most twice the largest difference
# this check measured (each path within that of the forward's logits).
CACHE_LOGIT_TOL = MERGE_LOGIT_TOL


def family_llm(cfg, device, seed=0, dtype=torch.bfloat16):
    """cfg's LLM in `dtype` (bf16 unless asked), random weights drawn on
    `device` from `seed`."""
    from llamole_tpu_torch.models.gllm import LLM

    llm = LLM(cfg, dtype=dtype, device=device)
    llm.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return llm.eval()


def _record_routes(llm, log):
    """Forward pre-hooks on every MoE layer: each call's top-k expert ids
    [B, S, k] (sorted) appended to log[layer]. Returns the handles."""
    import torch.nn.functional as F

    def hook(i):
        def pre(mod, args):
            probs = torch.softmax(F.linear(args[0], mod.router.weight)
                                  .float(), dim=-1)
            top = probs.topk(mod.cfg.num_experts_per_tok, dim=-1).indices
            log.setdefault(i, []).append(top.sort(dim=-1).values)
        return pre

    return [layer.mlp.register_forward_pre_hook(hook(i))
            for i, layer in enumerate(llm.layers) if layer.moe]


@torch.no_grad()
def cache_against_forward(llm, ids, mask, prefill, what, tag, gate=True):
    """The first `prefill` slots prefilled into a KV cache, the rest fed
    one a step (teacher-forced); the logits of the prefill's last slot
    and of every fed slot against one no-cache forward of the whole
    sequence. For an MoE LLM, also the (row, slot, layer) units the two
    paths route to different experts. Fails past CACHE_LOGIT_TOL (with
    `gate`); returns the largest absolute difference and the no-cache
    logits of those slots."""
    from llamole_tpu_torch.models.gllm.model import make_kv_cache

    b, s = ids.shape
    positions = (mask.cumsum(-1) - 1).clamp_min(0)
    routes = ({}, {})
    hooks = _record_routes(llm, routes[0])
    try:
        full = llm(input_ids=ids, attention_mask=mask)[0][:, prefill - 1:]
    finally:
        for h in hooks:
            h.remove()
    hooks = _record_routes(llm, routes[1])
    cache = make_kv_cache(llm.cfg, b, s, llm.dtype, ids.device)
    kv_valid = torch.zeros((b, s), dtype=torch.bool, device=ids.device)
    kv_valid[:, :prefill] = mask[:, :prefill] > 0
    pre = llm(input_ids=ids[:, :prefill], attention_mask=mask[:, :prefill],
              positions=positions[:, :prefill], kv_cache=cache,
              cache_index=0, kv_valid=kv_valid, last_logits_only=True)[0]
    steps = [pre[:, -1]]
    try:
        for t in range(prefill, s):
            kv_valid[:, t] = mask[:, t] > 0
            steps.append(llm(input_ids=ids[:, t:t + 1],
                             positions=positions[:, t:t + 1], kv_cache=cache,
                             cache_index=t, kv_valid=kv_valid)[0][:, -1])
    finally:
        for h in hooks:
            h.remove()
    cached = torch.stack(steps, dim=1)
    real = mask[:, prefill - 1:] > 0
    diff = float((cached - full).abs()[real].max())
    scale = float(full.abs()[real].max())
    top1 = float((cached.argmax(-1) == full.argmax(-1))[real].float().mean())
    routing = ""
    if routes[0]:
        real_all = mask > 0
        flips = sum(int((torch.cat(routes[1][i], dim=1) != routes[0][i][0])
                        .any(-1)[real_all].sum()) for i in routes[0])
        routing = (f", routed to other experts at {flips} of "
                   f"{int(real_all.sum()) * len(routes[0])} (row, slot, "
                   f"layer) units")
    bound = f"bound {CACHE_LOGIT_TOL}" if gate else "not gated"
    print(f"{what}: cached against no-cache logits over {int(real.sum())} "
          f"slots ({s - prefill} fed one a step after a {prefill}-slot "
          f"prefill): max abs diff {diff:.4e}, over max |logit| "
          f"{diff / scale:.4e} ({bound}), top-1 agreement {top1:.4f}"
          f"{routing} [{tag}]", flush=True)
    if gate and not diff / scale < CACHE_LOGIT_TOL:
        fail(f"{what}: cached logits {diff / scale:.4e} off the forward's")
    return diff, full


@torch.no_grad()
def _greedy_timed(llm, ids, mask, steps, spec):
    """(tokens, decode tok/s, verify steps or None): a greedy generate's
    wall less a prefill's, between syncs of the card."""
    _sync_card()
    t0 = time.perf_counter()
    llm(input_ids=ids, attention_mask=mask, last_logits_only=True)
    _sync_card()
    t1 = time.perf_counter()
    out, _, iters = llm.generate(ids, mask, max_new_tokens=steps,
                                 do_sample=False, spec_tokens=spec,
                                 return_spec_iters=True)
    _sync_card()
    t2 = time.perf_counter()
    rate = ids.shape[0] * steps / max((t2 - t1) - (t1 - t0), 1e-9)
    return out, rate, iters


@torch.no_grad()
def check_greedy_agreement(plain, drafted, logits, diff, what, tag):
    """Rows whose drafted tokens part from the per-token path's: each first
    difference must fall where the per-token path's top-2 logit gap (the
    no-cache forward's logits of prompt + its tokens, from the last
    prompt slot on) is at most 2 x diff. Returns the share of rows that
    agree throughout."""
    top2 = logits[:, :plain.shape[1]].topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu()
    differ = (plain != drafted).cpu()
    firsts = []
    for r in range(plain.shape[0]):
        if differ[r].any():
            t = int(differ[r].float().argmax())
            firsts.append((r, t, round(float(gap[r, t]), 4)))
            if float(gap[r, t]) > 2 * diff:
                fail(f"{what}: row {r} parts from the per-token path at "
                     f"step {t}, where its top-2 gap {float(gap[r, t]):.4f}"
                     f" > 2 x {diff:.4e}")
    agree = 1.0 - len(firsts) / plain.shape[0]
    print(f"{what}: rows agreeing with the per-token path {agree:.4f}; "
          f"first differences (row, step, top-2 gap) {firsts} (limit "
          f"{2 * diff:.4e}) [{tag}]", flush=True)
    return agree


def _cache_and_drafts(llm, ids, mask, plain, drafted, what, tag):
    """cache_against_forward over prompt + the per-token path's tokens,
    then check_greedy_agreement on its logits: (diff, share agreeing)."""
    seq = torch.cat([ids, plain], dim=1)
    m = torch.cat([mask, torch.ones_like(plain, dtype=mask.dtype)], dim=1)
    diff, logits = cache_against_forward(llm, seq, m, ids.shape[1], what,
                                         tag)
    return diff, check_greedy_agreement(plain, drafted, logits, diff, what,
                                        tag)


def _spec_report(llm):
    st = getattr(llm, "spec_stats", None) or {}
    acc = st.get("accepted", 0) / max(st.get("live_steps", 0), 1)
    return (f"{acc:.3f} accepted drafts a verify step and row over "
            f"{st.get('iterations')} verify steps, guard tripped "
            f"{st.get('guard_tripped')}")


def run_qwen3(tok, tag, device="cuda", sizes=None, cfg=None, phase21=None):
    """Phase 15 (a), and with phase21 then phase 21 (b) on its LLM (its
    record into phase21["b"]). Returns its records."""
    from llamole_tpu_torch.models.gllm import LLMConfig

    sizes = sizes or FAMILIES
    cfg = cfg or dataclasses.replace(LLMConfig.qwen3_8b(),
                                     num_layers=sizes["qwen3_layers"])
    t0 = time.perf_counter()
    llm = family_llm(cfg, device)
    print(f"qwen3 LLM ({sum(p.numel() for p in llm.parameters())} "
          f"parameters, bf16) drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ids, mask = _prompt_batch(tok, sizes["prompts"], device)
    steps, k = sizes["greedy_tokens"], sizes["spec_tokens"]
    records = {}
    base = llm.cfg
    try:
        for kv in ("compute", "int8"):
            llm.cfg = dataclasses.replace(base, kv_cache_dtype=kv)
            what = f"qwen3 ({kv} KV cache)"
            plain, plain_rate, _ = _greedy_timed(llm, ids, mask, steps, 0)
            drafted, spec_rate, iters = _greedy_timed(llm, ids, mask, steps,
                                                      k)
            stats = dict(llm.spec_stats)
            diff, agree = _cache_and_drafts(llm, ids, mask, plain, drafted,
                                            what, tag)
            print(f"{what}: greedy decode at batch {ids.shape[0]}, {steps} "
                  f"tokens: {plain_rate:.1f} tok/s per-token, "
                  f"{spec_rate:.1f} tok/s with drafts (K={k}); "
                  f"{_spec_report(llm)} [{tag}]", flush=True)
            records[kv] = {"tok_s": plain_rate, "spec_tok_s": spec_rate,
                           "stats": stats, "agree": agree, "diff": diff}
    finally:
        llm.cfg = base
    if phase21 is not None:
        phase21["b"] = run_qk_norm_tp(llm, ids, mask, tag, device,
                                      phase21.get("sizes"))
    return records


def long_prompt(tok, n, device):
    """One row of exactly n tokens, PROMPT repeated."""
    ids = []
    while len(ids) < n:
        ids += tok.encode(PROMPT + " ")
    ids = torch.tensor([ids[:n]], device=device)
    return ids, torch.ones_like(ids, dtype=torch.int32)


@torch.no_grad()
def run_gemma3(tok, tag, device="cuda", sizes=None, cfg=None):
    """Phase 15 (c). Returns its records."""
    from llamole_tpu_torch.models.gllm import LLMConfig

    sizes = sizes or FAMILIES
    cfg = cfg or dataclasses.replace(LLMConfig.gemma3_12b(),
                                     num_layers=sizes["gemma3_layers"])
    llm = family_llm(cfg, device)
    n, steps = sizes["long_prompt"], sizes["long_steps"]
    ids, mask = long_prompt(tok, n, device)
    if not n > cfg.sliding_window >= sizes["long_prefill"] - 1:
        fail(f"gemma-3: a {n}-token prompt does not cross the "
             f"{cfg.sliding_window}-token window after the prefill")
    local = sum(not cfg.is_global_layer(i) for i in range(cfg.num_layers))
    diff, _ = cache_against_forward(
        llm, ids, mask, sizes["long_prefill"],
        f"gemma-3 ({local} of {cfg.num_layers} layers windowed at "
        f"{cfg.sliding_window})", tag)
    _sync_card()
    t0 = time.perf_counter()
    out, _, iters, state = llm.generate(ids, mask, max_new_tokens=steps,
                                        do_sample=False,
                                        return_spec_iters=True,
                                        return_decode_state=True)
    _sync_card()
    wall = time.perf_counter() - t0
    slots = state["cache"][0]["k"].shape[1] if state else None
    if iters != steps or state is None or slots != n + steps:
        fail(f"gemma-3: drafts ran under the sliding window ({iters} "
             f"steps, cache slots {slots})")
    print(f"gemma-3: {steps} greedy steps on the {n}-token prompt in "
          f"{wall:.3f} s (prefill included), drafts off (spec_tokens auto: "
          f"{iters} per-token steps, a {slots}-slot cache) [{tag}]",
          flush=True)
    return {"diff": diff, "wall": wall}


def _drop_counter(llm):
    """Zero drop counters on every MoE layer; returns a reader of their
    sum."""
    for layer in llm.layers:
        layer.mlp.drop_count = torch.zeros((), dtype=torch.long,
                                           device=llm.device)
    return lambda: sum(int(layer.mlp.drop_count) for layer in llm.layers)


@torch.no_grad()
def moe_drops(llm, ids, mask, steps):
    """(greedy tokens, units dropped at prefill, at decode): one greedy
    generate with every layer's drop counter on, the prefill's read by a
    hook after the first forward."""
    read = _drop_counter(llm)
    after = []
    hook = llm.register_forward_hook(lambda m, i, o: after.append(read()))
    try:
        out, _ = llm.generate(ids, mask, max_new_tokens=steps,
                              do_sample=False, spec_tokens=0)
    finally:
        hook.remove()
        for layer in llm.layers:
            layer.mlp.drop_count = None
    return out, after[0], after[-1] - after[0]


def moe_train_batch(tok, rows, device):
    """`rows` records of data/molqa_train_examples.json collated as
    run_mmsft collates them (cutoff 768, MAX_NODES)."""
    from llamole_tpu_torch.data.collator import SeqGraphCollator
    from llamole_tpu_torch.data.loader import get_dataset

    data_args = SimpleNamespace(
        dataset="molqa_train_examples",
        dataset_dir=str(Path(__file__).resolve().parent / "data"),
        max_samples=None, template="default", learned_query_size=8,
        cutoff_len=768, train_on_prompt=False)
    bank, inputs = get_dataset(None, data_args, None, tok)
    collate = SeqGraphCollator(tokenizer=tok, mol_id_to_graph=bank,
                               max_len=768, max_nodes=MAX_NODES,
                               max_graphs=16, max_retro=16)
    return collate(inputs[:rows])


def run_mixtral(kernels, tag, device="cuda", sizes=None, cfg=None,
                build=None, phase20=None):
    """Phase 15 (d). In bf16: the capacity drops at the preset's factor,
    64 greedy tokens per-token and with drafts, the cache against the
    forward at a capacity of E (not gated: there a router's top two
    probabilities tie often enough in bf16 that the two paths send a
    token to other experts, which changes its output wholesale; the
    routing differences are printed), one loss and backward, and on its
    model phase 20 (b) (run_moe_ep; its record into phase20 when given).
    Then in f32 (the same seed's weights before their bf16 rounding) at
    a capacity of E: the gated cache and drafts checks of (a). Returns
    the B and C launches of the loss and backward, and its records."""
    from llamole_tpu_torch.models.gllm import LLMConfig

    sizes = sizes or FAMILIES
    cfg = cfg or dataclasses.replace(LLMConfig.mixtral_8x7b(),
                                     num_layers=sizes["moe_layers"])
    build = build or build_slice
    on_card = device == "cuda"
    from llamole_tpu_torch.models.loader import offline_tokenizer

    llm = family_llm(cfg, device)
    ids, mask = _prompt_batch(offline_tokenizer(), sizes["prompts"], device)
    steps, k, e = sizes["moe_tokens"], sizes["spec_tokens"], cfg.num_experts
    units = cfg.num_experts_per_tok * cfg.num_layers
    plain, pre_drop, dec_drop = moe_drops(llm, ids, mask, steps)
    _, rate, _ = _greedy_timed(llm, ids, mask, steps, 0)
    drafted, spec_rate, _ = _greedy_timed(llm, ids, mask, steps, k)
    agree = float((plain == drafted).all(1).float().mean())
    print(f"Mixtral ({cfg.num_layers} of 32 layers, bf16, capacity factor "
          f"{cfg.moe_capacity_factor}): units dropped for capacity at "
          f"prefill {pre_drop} of {int(mask.sum()) * units}, over {steps} "
          f"decode steps {dec_drop} of {ids.shape[0] * steps * units}; "
          f"greedy decode at batch {ids.shape[0]}: {rate:.1f} tok/s "
          f"per-token, {spec_rate:.1f} tok/s with drafts (K={k}); rows "
          f"agreeing {agree:.4f} (a verify step routes {k + 1} tokens a "
          f"row, so its drops differ); {_spec_report(llm)} [{tag}]",
          flush=True)
    factor = llm.cfg.moe_capacity_factor
    llm.cfg.moe_capacity_factor = float(e)     # the layers share this cfg
    try:
        seq = torch.cat([ids, plain], dim=1)
        cache_against_forward(
            llm, seq, torch.cat([mask, torch.ones_like(plain, dtype=mask
                                                        .dtype)], 1),
            ids.shape[1], f"Mixtral (bf16, capacity factor {e}: no drops)",
            tag, gate=False)
    finally:
        llm.cfg.moe_capacity_factor = factor

    # one loss and backward through GraphLM.loss, the router term in it
    model, tok = build(llm)
    del llm
    batch = moe_train_batch(tok, sizes["train_batch"], device)
    aux = []
    hook = model.llm.register_forward_hook(
        lambda m, i, o: aux.append(o[3].detach()) if len(o) == 4 else None)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    model.train()
    t0 = time.perf_counter()
    try:
        total, parts = model.loss(batch, torch.Generator(
            device=device).manual_seed(0), train=True)
        total.backward()
    finally:
        hook.remove()
        model.eval()
    _sync_card()
    wall = time.perf_counter() - t0
    launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                if on_card else {"B": 0, "C": 0})
    params = model.trainable_parameters()
    grads = [p.grad for p in params.values()]
    if (len(aux) != 1 or not torch.isfinite(total.detach())
            or not float(aux[0]) > 0
            or any(g is None or not torch.isfinite(g).all() for g in grads)):
        fail(f"Mixtral loss: total {float(total.detach())}, router aux "
             f"{aux}, {sum(g is None for g in grads)} trainable tensors "
             "without a gradient")
    if any(".mlp." in n for n in params):
        fail("Mixtral: the adapter covers MLP targets under MoE")
    print(f"Mixtral loss + backward at batch {sizes['train_batch']} "
          f"({tuple(batch['input_ids'].shape)} tokens): total "
          f"{total.item():.4f}, lm (router term in) "
          f"{parts['lm_loss'].item():.4f}, router aux {float(aux[0]):.4f} x "
          f"coef {model.llm.cfg.moe_aux_loss_coef}, design "
          f"{parts['design_loss'].item():.4f}, retro "
          f"{parts['retro_loss'].item():.4f}; {len(grads)} trainable "
          f"tensors with finite gradients (attention LoRA + connectors); B "
          f"{launches['B']}, C {launches['C']} launches; {wall:.3f} s; "
          f"peak {_peak(on_card)} [{tag}]", flush=True)
    want = (float(total.detach()), _grads(params))
    del total, parts, params, grads
    ep = run_moe_ep(model, batch, want, kernels, tag, device)
    if phase20 is not None:
        phase20["b"] = ep
    del model, want
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the gated checks in f32 at a capacity of E
    from llamole_tpu_torch.models.gllm import LLM
    llm = LLM(dataclasses.replace(cfg, moe_capacity_factor=float(e)),
              dtype=torch.float32, device=device)
    llm.reset_parameters(torch.Generator(device=device).manual_seed(0))
    llm.eval()
    plain32, rate32, _ = _greedy_timed(llm, ids, mask, steps, 0)
    drafted32, spec32, _ = _greedy_timed(llm, ids, mask, steps, k)
    _, nodrop, _ = moe_drops(llm, ids, mask, 1)
    if nodrop:
        fail(f"Mixtral at capacity factor {e}: {nodrop} units dropped")
    what = f"Mixtral (f32, capacity factor {e}: no drops)"
    diff, agree32 = _cache_and_drafts(llm, ids, mask, plain32, drafted32,
                                      what, tag)
    print(f"{what}: greedy decode at batch {ids.shape[0]}, {steps} tokens: "
          f"{rate32:.1f} tok/s per-token, {spec32:.1f} tok/s with drafts "
          f"(K={k}); {_spec_report(llm)} [{tag}]", flush=True)
    return launches, {"agree": agree, "agree_f32": agree32,
                      "drops": (pre_drop, dec_drop), "diff": diff}


def run_families(kernels, tag, device="cuda", sizes=None, build=None,
                 cfgs=None, phase7=None, phase20=None, phase21=None):
    """Phase 15 on an empty card: (a) qwen3, (b) gemma-2 serving, (c)
    gemma-3, (d) Mixtral (and phase 20 (b) on its model: phase20 takes
    its record; with phase21, phase 21 (b) on (a)'s LLM and (c) on (b)'s
    model), each model freed before the next. cfgs: the four LLM configs
    (the presets by default). Returns the A, B and C launches of (b) and
    (d)."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.loader import offline_tokenizer

    sizes = sizes or FAMILIES
    build = build or build_slice
    cfgs = cfgs or {}
    on_card = device == "cuda"
    tok = offline_tokenizer()

    def freed():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_qwen3(tok, tag, device, sizes, cfgs.get("qwen3"), phase21)
    freed()
    print(f"phase 15 (a) qwen3: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    llm = family_llm(cfgs.get("gemma2") or dataclasses.replace(
        LLMConfig.gemma2_9b(), num_layers=sizes["gemma2_layers"]), device)
    model, stok = build(llm)
    del llm
    served = serve_quantized(model, stok, kernels, tag, sizes, phase7,
                             what="gemma-2 serving (bf16, compute-dtype "
                                  "KV cache)")
    if phase21 is not None:
        phase21["c"] = run_tied_zero3(
            model, moe_train_batch(stok, sizes["train_batch"], device),
            kernels, tag, device, phase21.get("sizes"))
    del model
    freed()
    print(f"phase 15 (b) gemma-2: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    run_gemma3(tok, tag, device, sizes, cfgs.get("gemma3"))
    freed()
    print(f"phase 15 (c) gemma-3: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    trained, _ = run_mixtral(kernels, tag, device, sizes, cfgs.get("mixtral"),
                             build, phase20)
    freed()
    print(f"phase 15 (d) Mixtral: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"A": served["A"], "A_mma": served["A_mma"],
            "A_fma": served["A_fma"], "B": served["B"] + trained["B"],
            "C": trained["C"]}


# Phase 16, the rest of training (after phase 15, on an emptied card), at
# the slice's Llama-3.1-8B width (bf16, random weights from seed 0), over
# phase 7's graph modules: each part runs run_mmsft through its normal
# entry with llama_lora.yaml's settings and TRAIN_DEVIATIONS, 4 micro
# steps and 2 updates. (a) DoRA + LoRA+ + shift_attn on the slice, (b)
# PiSSA + DoRA, (c) GaLore and then BAdam with finetuning_type full; (b)
# and (c) build through the loader from a config.json of the 8B width at
# their depths (whose base it draws again from the seed when it reloads
# an export) and from the graph modules (a) saved. (a) runs all 32 layers.
FINETUNE = {"dora_layers": 32, "pissa_layers": 2, "galore_layers": 2,
            "badam_layers": 4, "loraplus_lr_ratio": 16.0, "galore_rank": 16,
            "galore_update_interval": 200, "galore_scale": 0.25,
            "badam_n_blocks": 4, "badam_switch_interval": 1}
# (b)'s export is rank 2r: llama_lora.yaml's rank 8
PISSA_EXPORT_RANK = 16


def finetune_args(out_dir, model_dir=None, modules=None, **finetuning):
    """llama_lora_args' settings (TRAIN_DEVIATIONS; llama_lora.yaml's
    method and precision keys included) with these finetuning arguments
    and, when given, the LLM's config directory and the directory of
    save_graph_modules, through get_train_args."""
    from llamole_tpu_torch.config import get_train_args

    args = llama_lora_dict(out_dir)
    args.update(finetuning)
    if model_dir is not None:
        args["model_name_or_path"] = model_dir
    if modules is not None:
        args.update({f"{name}_path": os.path.join(modules, name)
                     for name in GRAPH_MODULES})
    return get_train_args(args)


GRAPH_MODULES = ("graph_decoder", "graph_encoder", "graph_predictor")


def _graph_checksum(model) -> float:
    return _checksum([p for name in GRAPH_MODULES
                      for p in getattr(model, name).parameters()])


def save_graph_modules(model, path):
    """The composite's three graph modules, each in its directory under
    path in the JAX package's layout (what the loader's graph_*_path
    reads), and their checksum for check_graph_modules."""
    for name in GRAPH_MODULES:
        getattr(model, name).save_pretrained(os.path.join(path, name))
    with open(os.path.join(path, "checksum.json"), "w") as f:
        json.dump(_graph_checksum(model), f)


def check_graph_modules(model, path, what):
    """Fails unless the loader built model's graph modules from those
    save_graph_modules wrote under path (their checksum)."""
    with open(os.path.join(path, "checksum.json")) as f:
        saved = json.load(f)
    got = _graph_checksum(model)
    if got != saved:
        fail(f"{what}: the graph modules' checksum {got} is not that of "
             f"the saved ones, {saved}")


def llm_config_dir(work, cfg, name):
    """A directory holding cfg's config.json and no weights: the loader
    resolves the config from it and draws the LLM from the seed."""
    from llamole_tpu_torch.models.gllm.convert import to_hf_config

    path = os.path.join(work, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(to_hf_config(cfg), f)
    return path


def _last_logits(model, tok, device):
    """The LLM's last-token logits (f32) of phase 12's PROMPT."""
    ids = torch.tensor([tok.encode(PROMPT)], device=device)
    with torch.no_grad():
        logits, _, _ = model.llm(input_ids=ids,
                                 attention_mask=torch.ones_like(ids),
                                 last_logits_only=True)
    return logits[:, -1].float()


def _logit_gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@contextlib.contextmanager
def plain_gin_calls(on_card):
    """Counts the calls of the GIN plain versions (G.*_reference) inside
    the block: on the card the path must launch kernels B and C only."""
    from llamole_tpu_torch.ops import gin_aggregate as G

    calls = [0]
    refs = (G.gin_aggregate_reference, G.gin_aggregate_backward_reference)

    def counted(fn):
        def call(*args):
            calls[0] += 1
            return fn(*args)
        return call

    G.gin_aggregate_reference, G.gin_aggregate_backward_reference = (
        counted(refs[0]), counted(refs[1]))
    try:
        yield calls
    finally:
        G.gin_aggregate_reference, G.gin_aggregate_backward_reference = refs
    if on_card and calls[0]:
        fail(f"the path called a plain GIN version {calls[0]} times on the "
             "card")


def _train_log(out_dir, steps, what):
    with open(Path(out_dir) / "trainer_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    if len(log) != steps:
        fail(f"{what}: {len(log)} logged micro steps, expected {steps}")
    for rec in log:
        if not all(np.isfinite([rec[k] for k in (
                "loss", "lm_loss", "design_loss", "retro_loss",
                "grad_norm")])):
            fail(f"{what}: non-finite loss in {rec}")
    return log


def _step_report(metrics, log, what, tag, beside=""):
    for i, (st, rec) in enumerate(zip(metrics["step_times"], log)):
        total = st["forward_s"] + st["backward_s"] + st["optimizer_s"]
        print(f"{what} micro step {i + 1}: {st['tokens']} tokens, wall "
              f"{total:.3f} s = forward {st['forward_s']:.3f} + backward "
              f"{st['backward_s']:.3f} + optimizer {st['optimizer_s']:.3f};"
              f" {st['tokens'] / total:.1f} tok/s; loss {rec['loss']:.4f}"
              f"{beside} [{tag}]", flush=True)


def check_finetune_launches(launches, what):
    """Kernels B and C launched on the GIN layers of run_mmsft's 4 micro
    steps (the predictor's backward, GraphCLIP's and the predictor's
    forwards)."""
    check_launches(f"gin_aggregate_backward ({what})", launches["C"],
                   (GIN_LAYERS - 1) * 4,
                   f"{GIN_LAYERS - 1} predictor layers x 4 micro steps")
    check_launches(f"gin_aggregate ({what})", launches["B"],
                   2 * GIN_LAYERS * 4,
                   f"({GIN_LAYERS} GraphCLIP + {GIN_LAYERS} predictor "
                   "layers) x 4")


def run_dora(kernels, tag, device, sizes, build, phase9, modules,
             phase20=None):
    """Phase 16 (a): DoRA + LoRA+ + shift_attn over phase 7's graph
    modules, which it saves first under modules (save_graph_modules) for
    (b) and (c); then phase 20 (c) on its model and its last training
    batch (run_s2_tp; its record into phase20 when given). Returns the B
    and C launches of run_mmsft."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.gllm.model import s2_attention
    from llamole_tpu_torch.train.workflow import run_mmsft

    cfg = dataclasses.replace(sizes.get("cfg") or LLMConfig.llama3_8b(),
                              num_layers=sizes["dora_layers"],
                              shift_attn=True)
    llm = family_llm(cfg, device)
    model, tok = build(llm)
    del llm
    t0 = time.perf_counter()
    save_graph_modules(model, modules)
    print(f"phase 7's graph modules saved for (b) and (c) in "
          f"{time.perf_counter() - t0:.3f} s [{tag}]", flush=True)
    model.use_dora = True
    model.init_pissa_dora()          # init_trainable's DoRA step: m = ||W||
    cfg = model.llm.cfg
    params = model.trainable_parameters()
    start = _snapshot(params)
    base = [p for n, p in model.llm.named_parameters() if "lora_" not in n]
    base_sum = _checksum(base)
    s2 = {"training": 0, "eval": 0, "generation": 0}
    loss, generate = model.loss, model.llm.generate
    last_batch = []

    def watched(batch, generator=None, train=True, noisy=None):
        c0 = s2_attention.calls
        out = loss(batch, generator, train, noisy)
        s2["training" if train else "eval"] += s2_attention.calls - c0
        if train:
            last_batch[:] = [batch]
        return out

    def generating(*args, **kwargs):
        c0 = s2_attention.calls
        out = generate(*args, **kwargs)
        s2["generation"] += s2_attention.calls - c0
        return out

    model.loss, model.llm.generate = watched, generating
    args = finetune_args(os.path.join(sizes["work"], "dora"), use_dora=True,
                         loraplus_lr_ratio=sizes["loraplus_lr_ratio"])
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts(*kernels)
    try:
        t0 = time.perf_counter()
        metrics = run_mmsft(*args, prebuilt=(model, tok))
        wall = time.perf_counter() - t0
    finally:
        del model.loss, model.llm.generate
    peak = _peak(device == "cuda")
    launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                if device == "cuda" else {"B": 0, "C": 0})
    log = _train_log(args[2].output_dir, 4, "DoRA")
    # B starts at 0, so A's gradient is 0 until the first nonzero update
    # moves B: "the LoRA" is A and B together, as in phase 9
    groups = {"m": ("lora_m",), "LoRA": ("lora_a", "lora_b"),
              "connectors": ("connectors.",)}
    unchanged = [g for g, keys in groups.items()
                 if not any(not torch.equal(params[n], start[n])
                            for n in params if any(k in n for k in keys))]
    if unchanged or not any("lora_m" in n for n in params):
        fail(f"DoRA: unchanged after the second update: {unchanged}")
    if _checksum(base) != base_sum:
        fail("DoRA: the frozen base changed in training")
    need = cfg.num_layers * 4
    print(f"S²-attn calls (shift_attn, groups of a quarter of the "
          f"sequence): in the training forwards {s2['training']} (need "
          f"{need} = {cfg.num_layers} layers "
          f"x 4 micro steps), in generation {s2['generation']} (need 0), in "
          f"the held-out loss {s2['eval']} (JAX's loss_fn hands its LLM "
          f"train=True too) [{tag}]", flush=True)
    if s2["training"] != need or s2["generation"]:
        fail(f"S²-attn ran {s2} times, expected {need} in training and none "
             "in generation")
    if device == "cuda":
        check_finetune_launches(launches, "DoRA training")
    beside = ""
    if phase9:
        beside = (f"; phase 9 in this run: {min(phase9['step_s']):.3f}"
                  f"-{max(phase9['step_s']):.3f} s a step, "
                  f"{min(phase9['tok_s']):.1f}-{max(phase9['tok_s']):.1f} "
                  "tok/s")
    _step_report(metrics, log, "DoRA", tag, beside)
    print(f"phase 16 (a) DoRA + LoRA+ ({sizes['loraplus_lr_ratio']}) + "
          f"shift_attn at {cfg.num_layers} layers: run_mmsft {wall:.3f} s, "
          f"m, the LoRA and the connectors changed, the base checksum "
          f"{base_sum} unchanged; B {launches['B']}, C {launches['C']} "
          f"launches; peak {peak}"
          + (f" against phase 9's {phase9['peak']} in this run"
             if phase9 else "") + f" [{tag}]", flush=True)
    del params, start, base
    s2_tp = run_s2_tp(model, last_batch[0], kernels, tag, device)
    if phase20 is not None:
        phase20["c"] = s2_tp
    del model, tok, last_batch
    return launches


def svd_seconds(shapes, device):
    """One f32 torch.linalg.svd (full_matrices=False) of a random matrix of
    each shape, timed between synchronizations."""
    gen = torch.Generator(device=device).manual_seed(3)
    out = {}
    for shape in shapes:
        w = torch.randn(shape, device=device, generator=gen)
        _sync_card()
        t0 = time.perf_counter()
        torch.linalg.svd(w, full_matrices=False)
        _sync_card()
        out[shape] = time.perf_counter() - t0
        del w
    return out


def _f32_logits(model, tok, device):
    """_last_logits with the LLM widened to f32 in place: its bf16 base
    widens exactly, and DoRA's effective weight reaches each product
    without the cast to the compute dtype."""
    model.llm.float()
    return _last_logits(model, tok, device)


def _bf16_kept(before, after) -> float:
    """The share of the f32 update after - before that reaches the tensor
    rounded to bf16: <Q(after) - Q(before), d> / <d, d> with d = after -
    before and Q the rounding (1 when the rounding keeps the update on
    average, 0 when it drops it)."""
    d = after - before
    q = after.to(torch.bfloat16).float() - before.to(torch.bfloat16).float()
    return float((q * d).sum() / (d * d).sum())


def run_pissa(kernels, tag, device, sizes, modules):
    """Phase 16 (b): PiSSA + DoRA through the loader at pissa_layers of
    the 8B width over phase 7's graph modules (under modules), bf16: the
    composite's last-token logits before training against the unmodified
    base's, run_mmsft, the export's rank, and the export reloaded onto
    the original base through build_graph_lm(load_adapter=True) against
    the trained model. The reload is held to MERGE_LOGIT_TOL with both
    LLMs widened to f32: the same bf16 bases and f32 adapters, without
    the cast to bf16 that DoRA's effective weight takes before each
    product (as in JAX's _proj). In bf16 that cast parts the two: the
    reloaded base lies on the bf16 grid, so an update below half a bf16
    step rounds away, while PiSSA's in-memory residual (rounded to bf16)
    plus the f32 principal part lies off it and keeps the update on
    average. The bf16 gap is reported beside the share of training's
    update to layer 0 q's DoRA weight that survives the cast in each
    model (_bf16_kept)."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.gllm.lora import dora_weight, pissa_to_lora
    from llamole_tpu_torch.models.loader import build_graph_lm
    from llamole_tpu_torch.train.workflow import run_mmsft
    from llamole_tpu_torch.utils.serialization import load_pytree

    cfg = dataclasses.replace(sizes.get("cfg") or LLMConfig.llama3_8b(),
                              num_layers=sizes["pissa_layers"])
    h, inter, kv = (cfg.hidden_size, cfg.intermediate_size,
                    cfg.num_kv_heads * cfg.head_dim_)
    svd = svd_seconds(sorted({(h, h), (h, kv), (h, inter), (inter, h)}),
                      device)
    print("PiSSA: one f32 torch.linalg.svd a projection shape ([in, out]): "
          + ", ".join(f"{s[0]} x {s[1]} {t:.3f} s" for s, t in svd.items())
          + f"; {7 * cfg.num_layers} projections [{tag}]", flush=True)
    model_dir = llm_config_dir(sizes["work"], cfg, "pissa_llm")
    out_dir = os.path.join(sizes["work"], "pissa")
    plain = finetune_args(out_dir, model_dir, modules)
    args = finetune_args(out_dir, model_dir, modules, use_dora=True,
                         pissa_init=True)
    seed = args[2].seed
    base, tok = build_graph_lm(*plain[:2], plain[3], device=device,
                               seed=seed)
    want = _last_logits(base, tok, device)
    del base
    gc.collect()
    _sync_card()
    t0 = time.perf_counter()
    model, tok = build_graph_lm(*args[:2], args[3], device=device, seed=seed)
    _sync_card()
    built = time.perf_counter() - t0
    check_graph_modules(model, modules, "PiSSA")
    gap = _logit_gap(_last_logits(model, tok, device), want)
    print(f"PiSSA + DoRA build (the SVDs, the residual base, m): "
          f"{built:.3f} s; last-token logits before training {gap:.3e} of "
          f"the largest from the unmodified base's (bound "
          f"{MERGE_LOGIT_TOL}) [{tag}]", flush=True)
    if not gap < MERGE_LOGIT_TOL:
        fail(f"PiSSA + DoRA changed the untrained logits by {gap}")
    q = model.llm.layers[0].attn["q"]
    scale = q.lora_scale
    a0, b0, m0 = (t.detach().clone() for t in (q.lora_a, q.lora_b, q.lora_m))
    untrained = dora_weight(q.weight, a0, b0, m0, scale)
    reset_counts(*kernels)
    metrics = run_mmsft(*args, prebuilt=(model, tok))
    launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                if device == "cuda" else {"B": 0, "C": 0})
    if device == "cuda":
        check_finetune_launches(launches, "PiSSA training")
    _train_log(out_dir, 4, "PiSSA")
    trained = _last_logits(model, tok, device)
    moved = _logit_gap(trained, want)
    with torch.no_grad():
        kept_memory = _bf16_kept(untrained, dora_weight(
            q.weight, q.lora_a, q.lora_b, q.lora_m, scale))
    trained32 = _f32_logits(model, tok, device)
    del model, q, untrained
    gc.collect()
    adapter = load_pytree(os.path.join(out_dir, "adapter.msgpack"))
    leaf = adapter["layers"][0]["attn"]["q"]
    rank = int(leaf["a"].shape[1])
    if rank != PISSA_EXPORT_RANK or "m" not in leaf:
        fail(f"the PiSSA export has rank {rank} (expected "
             f"{PISSA_EXPORT_RANK}) and keys {sorted(leaf)}")
    m2 = dataclasses.replace(args[0], adapter_name_or_path=out_dir)
    reloaded, tok = build_graph_lm(m2, args[1], args[3], device=device,
                                   seed=seed, load_adapter=True)
    gap16 = _logit_gap(_last_logits(reloaded, tok, device), trained)
    rq = reloaded.llm.layers[0].attn["q"]
    with torch.no_grad():
        kept_reloaded = _bf16_kept(
            dora_weight(rq.weight, *pissa_to_lora(a0, b0, a0, b0), m0,
                        scale),
            dora_weight(rq.weight, rq.lora_a, rq.lora_b, rq.lora_m, scale))
    del rq
    gap32 = _logit_gap(_f32_logits(reloaded, tok, device), trained32)
    del reloaded
    gc.collect()
    print(f"phase 16 (b) PiSSA + DoRA at {len(adapter['layers'])} layers: "
          f"{metrics['train_steps']} micro steps (the logits moved "
          f"{moved:.3e} of the largest from the base's); adapter.msgpack "
          f"rank {rank} with m; reloaded onto the original base through "
          f"build_graph_lm(load_adapter=True): last-token logits with both "
          f"LLMs widened to f32 {gap32:.3e} of the largest from the trained "
          f"model's (bound {MERGE_LOGIT_TOL}), in bf16 {gap16:.3e}; the "
          f"share of training's update to layer 0 q's DoRA weight that "
          f"survives its bf16 cast: {kept_memory:.4f} in memory (the "
          f"residual off the bf16 grid), {kept_reloaded:.4f} reloaded (the "
          f"base on it) [{tag}]",
          flush=True)
    if not gap32 < MERGE_LOGIT_TOL:
        fail(f"the PiSSA export reloaded {gap32} away (f32)")
    return launches


def _state_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_galore(kernels, tag, device, sizes, modules):
    """Phase 16 (c), GaLore with full finetuning at galore_layers over
    phase 7's graph modules (under modules): the moments' bytes against
    AdamW's, the refresh SVD at the embedding's shape, and
    checkpoint-4's opt_state reloaded bit-identically into a new
    Trainer."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.loader import build_graph_lm
    from llamole_tpu_torch.train.optimizers import galore_basis
    from llamole_tpu_torch.train.trainer import Trainer
    from llamole_tpu_torch.train.workflow import run_mmsft

    cfg = dataclasses.replace(sizes.get("cfg") or LLMConfig.llama3_8b(),
                              num_layers=sizes["galore_layers"])
    out_dir = os.path.join(sizes["work"], "galore")
    args = finetune_args(
        out_dir, llm_config_dir(sizes["work"], cfg, "galore_llm"), modules,
        finetuning_type="full", use_galore=True,
        galore_rank=sizes["galore_rank"],
        galore_update_interval=sizes["galore_update_interval"],
        galore_scale=sizes["galore_scale"])
    model, tok = build_graph_lm(*args[:2], args[3], device=device,
                                seed=args[2].seed)
    check_graph_modules(model, modules, "GaLore")
    reset_counts(*kernels)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    last_batch, loss = [], model.loss

    def watched(batch, generator=None, train=True, noisy=None):
        if train:
            last_batch[:] = [batch]
        return loss(batch, generator, train, noisy)

    model.loss = watched
    try:
        with capture_checkpoints() as saved:
            t0 = time.perf_counter()
            metrics = run_mmsft(*args, prebuilt=(model, tok))
            wall = time.perf_counter() - t0
    finally:
        del model.loss
    peak = _peak(device == "cuda")
    launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                if device == "cuda" else {"B": 0, "C": 0})
    if device == "cuda":
        check_finetune_launches(launches, "GaLore training")
    log = _train_log(out_dir, 4, "GaLore")
    params = model.trainable_parameters()
    rec = saved["checkpoint-4"]
    trainer = Trainer(lambda batch, gen: None, params,
                      SimpleNamespace(**{**vars(rec["args"]),
                                         "output_dir": None}),
                      rec["updates"], finetuning_args=args[3])
    state = trainer.load_checkpoint(trainer.init_state(1), os.path.join(
        out_dir, "checkpoint-4"))
    opt = trainer.optimizer
    bad = [n for n in params if not torch.equal(params[n], rec["params"][n])]
    bad += [f"{k}:{n}" for k in ("mu", "nu", "acc", "proj")
            for n, t in getattr(opt, k).items()
            if not torch.equal(t, rec[k][n])]
    bad += [k for k, a, b in (("count", opt.count, rec["count"]),
                              ("mini_step", opt.mini_step, rec["mini_step"]),
                              ("step", state.step, rec["step"])) if a != b]
    if bad:
        fail(f"GaLore's checkpoint-4 did not reload bit-identically: "
             f"{bad[:3]}")
    low = sorted(opt.galore_names)
    moments = _state_bytes([*opt.mu.values(), *opt.nu.values()])
    adamw = 2 * _state_bytes(params.values())
    # the refresh at the embedding, on its gradient of the last batch
    # (rows zero but for the batch's tokens)
    embed = model.llm.embed.weight
    model.loss(last_batch[0], torch.Generator(device=device).manual_seed(0)
               )[0].backward()
    grad = embed.grad
    for p in params.values():
        p.grad = None
    _sync_card()
    t0 = time.perf_counter()
    galore_basis(grad, sizes["galore_rank"])
    _sync_card()
    refresh = time.perf_counter() - t0
    del grad
    _step_report(metrics, log, "GaLore", tag)
    print(f"phase 16 (c) GaLore (rank {sizes['galore_rank']}, interval "
          f"{sizes['galore_update_interval']}, scale {sizes['galore_scale']})"
          f", full finetuning at {cfg.num_layers} layers: run_mmsft "
          f"{wall:.3f} s; {len(low)} of {len(params)} leaves projected; "
          f"Adam moments {moments} bytes against AdamW's {adamw} "
          f"({moments / adamw:.4f}); refresh SVD of the embedding's "
          f"gradient [{embed.shape[0]}, {embed.shape[1]}] {refresh:.3f} s "
          f"({'gesvd' if device == 'cuda' else 'LAPACK'}); checkpoint-4 "
          f"(count {opt.count}, "
          f"{len(low)} bases) reloaded bit-identically into a new Trainer; "
          f"B {launches['B']}, C {launches['C']} launches; peak {peak} "
          f"[{tag}]", flush=True)
    del model, trainer, opt, params, saved, rec
    return launches


def run_badam(kernels, tag, device, sizes, modules):
    """Phase 16 (c), BAdam with full finetuning at badam_layers over phase
    7's graph modules (under modules): only the active block's leaves
    change at each update (the first update's learning rate is 0:
    nothing changes)."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    from llamole_tpu_torch.models.loader import build_graph_lm
    from llamole_tpu_torch.train.optimizers import badam_blocks
    from llamole_tpu_torch.train.workflow import run_mmsft

    cfg = dataclasses.replace(sizes.get("cfg") or LLMConfig.llama3_8b(),
                              num_layers=sizes["badam_layers"])
    out_dir = os.path.join(sizes["work"], "badam")
    args = finetune_args(
        out_dir, llm_config_dir(sizes["work"], cfg, "badam_llm"), modules,
        finetuning_type="full", use_badam=True,
        badam_n_blocks=sizes["badam_n_blocks"],
        badam_switch_interval=sizes["badam_switch_interval"])
    model, tok = build_graph_lm(*args[:2], args[3], device=device,
                                seed=args[2].seed)
    check_graph_modules(model, modules, "BAdam")
    params = model.trainable_parameters()
    block = badam_blocks(params, sizes["badam_n_blocks"])
    seen = []
    loss = model.loss

    def watched(batch, generator=None, train=True, noisy=None):
        if train and len(seen) in (0, 2):      # before updates 1 and 2
            seen.append(_snapshot(params))
        elif train:
            seen.append(None)
        return loss(batch, generator, train, noisy)

    model.loss = watched
    reset_counts(*kernels)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        metrics = run_mmsft(*args, prebuilt=(model, tok))
        wall = time.perf_counter() - t0
    finally:
        del model.loss
    peak = _peak(device == "cuda")
    launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                if device == "cuda" else {"B": 0, "C": 0})
    if device == "cuda":
        check_finetune_launches(launches, "BAdam training")
    log = _train_log(out_dir, 4, "BAdam")
    moved = []
    for i, (before, after) in enumerate(((seen[0], seen[2]),
                                         (seen[2], _snapshot(params)))):
        changed = {n for n in params if not torch.equal(before[n], after[n])}
        active = (i // sizes["badam_switch_interval"]) % sizes[
            "badam_n_blocks"]
        outside = sorted(n for n in changed if block[n] != active)
        moved.append((active, len(changed), sum(
            b == active for b in block.values())))
        if outside:
            fail(f"BAdam update {i + 1} (active block {active}) changed "
                 f"{len(outside)} leaves of other blocks: {outside[:3]}")
    if not moved[1][1]:
        fail("BAdam: the second update changed nothing")
    _step_report(metrics, log, "BAdam", tag)
    print(f"phase 16 (c) BAdam ({sizes['badam_n_blocks']} blocks, switch "
          f"every {sizes['badam_switch_interval']}), full finetuning at "
          f"{cfg.num_layers} layers: run_mmsft {wall:.3f} s; (active block, "
          f"leaves changed, leaves in the block) per update {moved} (update "
          f"1's learning rate is 0); B {launches['B']}, C {launches['C']} "
          f"launches; peak {peak} [{tag}]", flush=True)
    del model, params, seen
    return launches


def run_finetune(kernels, tag, device="cuda", sizes=None, build=None,
                 phase9=None, phase20=None):
    """Phase 16 on an empty card: (a) run_dora (and phase 20 (c) on its
    model: phase20 takes its record), (b) run_pissa, (c) run_galore then
    run_badam, each model freed before the next, all over phase 7's graph
    modules ((a) saves them for the others). Returns the B and C
    launches of the four runs together."""
    sizes = dict(sizes or FINETUNE)
    build = build or build_slice
    on_card = device == "cuda"
    total = {"B": 0, "C": 0}

    def freed():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_finetune_")
    sizes["work"] = work
    modules = os.path.join(work, "modules")
    try:
        with plain_gin_calls(on_card) as plain:
            for part, fn in (
                    ("(a) DoRA", lambda: run_dora(kernels, tag, device, sizes,
                                                  build, phase9, modules,
                                                  phase20)),
                    ("(b) PiSSA", lambda: run_pissa(kernels, tag, device,
                                                    sizes, modules)),
                    ("(c) GaLore", lambda: run_galore(kernels, tag, device,
                                                      sizes, modules)),
                    ("(c) BAdam", lambda: run_badam(kernels, tag, device,
                                                    sizes, modules))):
                t0 = time.perf_counter()
                got = fn()
                freed()
                for k in total:
                    total[k] += got[k]
                print(f"phase 16 {part}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
        print(f"phase 16: kernel B {total['B']}, kernel C {total['C']} "
              f"launches; plain GIN calls {plain[0]} [{tag}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return total


# Phase 20: ring attention on the sp axis, MoE expert parallelism and
# S²-attn under tp, each on a world-size-1 process group (NCCL on the
# card, which refuses two ranks on one card: the splitting itself, the
# ring's rotation, ep's combine and the dp count exchange, is held by the
# gloo tests). (a) ring_attention at the 8B attention width (32 heads x
# 128, bf16, B 1, S 4096, the last 512 keys padded), forward and backward
# against the plain causal attention with f32 logits; (b) inside phase 15
# (d), on its Mixtral model: GraphLM.loss and backward with the LLM
# placed on the mesh (shard_graph_lm: the MoE layers route through the
# count exchange and the aux's all-reduce) against (d)'s mesh-less loss
# and gradients, at the preset's capacity factor, where units drop;
# (c) inside phase 16 (a), on its DoRA + LoRA+ + shift_attn model after
# its run_mmsft: one more LongLoRA micro step without the mesh, then the
# same on the world-size-1 tp mesh (S²-attn with its global head offset).
# Gates: ring_out / ring_grad, the output's max |gap| / max |plain| and
# each gradient's relative L2 gap to the plain attention's (bf16: the
# ring divides by the softmax sum after its value product, the plain
# version before it; 3.984e-03 and 2.516e-03-2.644e-03 on an H100 at
# 700 W, so a fault in the online softmax shows with room over them);
# loss_gap (relative), grad_rel (the trainable
# gradients as one vector, relative L2) and leaf_rel (the largest
# single leaf) for (b) and (c), as phase 19 gates its pipeline.
PHASE20 = {"mesh": "dp:1,tp:1", "heads": 32, "head_dim": 128, "batch": 1,
           "seq": 4096, "padded": 512, "ring_out": 1e-2, "ring_grad": 1e-2,
           "loss_gap": 1e-3, "grad_rel": 1e-2, "leaf_rel": 5e-2}


@contextlib.contextmanager
def one_rank_group(device):
    """A world-size-1 process group for the block (NCCL on the card, gloo
    on the CPU), destroyed after it; yields the group."""
    import torch.distributed as dist
    from llamole_tpu_torch.parallel.mesh import init_distributed
    init_distributed(torch.device(device).type)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _grads(params):
    from llamole_tpu_torch.train.optimizers import local_data
    return {n: local_data(p.grad).float().clone()
            for n, p in params.items() if p.grad is not None}


def _grad_gaps(got, want):
    """(the gradients as one vector's relative L2 gap, the largest single
    leaf's and its name)."""
    names = sorted(want)
    if set(got) != set(want) or not names:
        fail(f"phase 20: gradients of {sorted(set(got) ^ set(want))[:3]} "
             "on one side only")
    diff = torch.stack([(got[n] - want[n]).norm() for n in names])
    norm = torch.stack([want[n].norm() for n in names])
    leaf = diff / norm.clamp_min(1e-30)
    return (float(diff.norm() / norm.norm().clamp_min(1e-30)),
            float(leaf.max()), names[int(leaf.argmax())])


def _gate_step(what, loss, want_loss, got, want, sizes, tag, extra=""):
    """Print and gate a placed step against its mesh-less one."""
    gap = abs(loss - want_loss) / max(abs(want_loss), 1e-30)
    rel, leaf, worst = _grad_gaps(got, want)
    print(f"{what}: loss {loss:.6f}, without the mesh {want_loss:.6f} "
          f"(relative gap {gap:.3e}, limit {sizes['loss_gap']}); {len(want)} "
          f"trainable gradients, relative L2 gap {rel:.3e} (limit "
          f"{sizes['grad_rel']}), largest leaf {leaf:.3e} ({worst}; limit "
          f"{sizes['leaf_rel']}){extra} [{tag}]", flush=True)
    if not np.isfinite(loss) or gap > sizes["loss_gap"]:
        fail(f"{what}: the loss {loss} strays from {want_loss}")
    if rel > sizes["grad_rel"] or leaf > sizes["leaf_rel"]:
        fail(f"{what}: the gradients stray ({rel}, {worst} {leaf})")
    return {"loss_gap": gap, "grad_rel": rel, "leaf_rel": leaf}


def _mesh_step(model, batch, device, sizes, zero3=False):
    """Place the GraphLM on a world-size-1 mesh (shard_graph_lm, at
    ZeRO-3 with zero3) and run one loss and backward on the whole batch
    (generator seed 0) -> (loss, the trainable gradients, seconds). The
    caller holds the group."""
    from llamole_tpu_torch.parallel.mesh import MeshGroups, mesh_from_string
    from llamole_tpu_torch.parallel.sharding import shard_graph_lm
    groups = MeshGroups(mesh_from_string(sizes["mesh"],
                                         torch.device(device).type))
    shard_graph_lm(model, groups, zero3=zero3)
    rows = len(np.asarray(batch["input_ids"]))
    batch = {**batch, "row_shard": np.asarray([0, rows], np.int64)}
    params = model.trainable_parameters()
    for p in params.values():
        p.grad = None
    _sync_card()
    t0 = time.perf_counter()
    total, _ = model.loss(batch, torch.Generator(device=device).manual_seed(0),
                          train=True)
    total.backward()
    _sync_card()
    return float(total.detach()), _grads(params), time.perf_counter() - t0


def run_moe_ep(model, batch, want, kernels, tag, device, sizes=None):
    """Phase 20 (b), on phase 15 (d)'s model right after its mesh-less loss
    and backward (want: its loss and trainable gradients): the same on
    the world-size-1 mesh, the MoE layers on their MoEMesh. Returns the
    gaps, B's and C's launches and the wall."""
    sizes = sizes or PHASE20
    t_part = time.perf_counter()
    with one_rank_group(device):
        reset_counts(*kernels)
        loss, grads, wall = _mesh_step(model, batch, device, sizes)
        launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                    if device == "cuda" else {"B": 0, "C": 0})
        mesh = model.llm.moe_mesh
        if mesh is None or not mesh.split_rows:
            fail("phase 20 (b): the MoE layers did not route on the mesh")
        out = _gate_step(
            f"phase 20 (b) Mixtral on the mesh {sizes['mesh']} (MoE layers "
            f"on their MoEMesh: data 1, ep 1)", loss, want[0], grads,
            want[1], sizes, tag,
            f"; capacity factor {model.llm.cfg.moe_capacity_factor}; "
            f"loss + backward {wall:.3f} s; B {launches['B']}, C "
            f"{launches['C']} launches")
    if device == "cuda":
        layers = model.graph_predictor.cfg.num_layer
        check_launches("gin_aggregate (phase 20 (b))", launches["B"], layers,
                       f"{layers} predictor layers")
        check_launches("gin_aggregate_backward (phase 20 (b))", launches["C"],
                       layers - 1, f"{layers - 1} predictor layers")
    return {**out, **launches, "wall": time.perf_counter() - t_part}


def run_s2_tp(model, batch, kernels, tag, device, sizes=None):
    """Phase 20 (c), on phase 16 (a)'s model after its run_mmsft: one
    LongLoRA micro step (GraphLM.loss with shift_attn and its backward)
    without the mesh, then on the world-size-1 tp mesh. Returns the gaps,
    the S²-attn calls of the mesh's step, B's and C's launches and the
    wall."""
    from llamole_tpu_torch.models.gllm.model import s2_attention
    sizes = sizes or PHASE20
    t_part = time.perf_counter()
    params = model.trainable_parameters()
    for p in params.values():
        p.grad = None
    total, _ = model.loss(batch, torch.Generator(device=device).manual_seed(0),
                          train=True)
    total.backward()
    want = (float(total.detach()), _grads(params))
    del total
    with one_rank_group(device):
        calls = s2_attention.calls
        reset_counts(*kernels)
        loss, grads, wall = _mesh_step(model, batch, device, sizes)
        s2 = s2_attention.calls - calls
        launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                    if device == "cuda" else {"B": 0, "C": 0})
        layers = model.llm.cfg.num_layers
        out = _gate_step(
            f"phase 20 (c) LongLoRA micro step on the tp mesh "
            f"{sizes['mesh']}", loss, want[0], grads, want[1], sizes, tag,
            f"; S²-attn calls {s2} (need {layers}); loss + backward "
            f"{wall:.3f} s; B {launches['B']}, C {launches['C']} launches")
    if s2 != layers:
        fail(f"phase 20 (c): S²-attn ran {s2} times, need {layers}")
    return {**out, **launches, "s2_calls": s2,
            "wall": time.perf_counter() - t_part}


# Phase 21: the mesh placements of ROADMAP.md Queue 1 item 9d, each on a
# world-size-1 process group (NCCL on the card: one card shows the
# placement's arithmetic, no splitting collective; the splitting is held
# by the gloo tests, tests/test_torch_mesh_placements.py). (a) inside
# phase 14, the int8 Llama-3.1-8B (full width and depth): on its serving
# slice (rank-8 LoRA, int8 KV cache) run_molqa's design on `records`
# records at `max_new_tokens` new tokens without the mesh (its decode
# graphed) and then with training_args.mesh (the int8 base placed, its
# decode eager): analyses, responses and SMILES equal; per scheme of
# phase 14 (b) (int4, W8A8, at its depth) the placed LLM's last-position
# logits against the mesh-less ones (max |gap| over max |logit| within
# logit_tol, the script's MERGE_LOGIT_TOL); phase 14 (d)'s QLoRA model,
# its trainable bundle restored to its start, through run_mmsft again at
# ZeRO-3 on the mesh (the int8 buffers in their dp chunks, all-gathered
# per product): each micro step's loss within loss_gap of (d)'s. (b)
# inside phase 15 (a), on its qwen3 LLM (full width, 4 of 36 layers),
# freeze-tuned with the per-head q / k norms trainable: one LM loss and
# backward without the mesh, then with the LLM placed on tp (the norms'
# one scale entering through to_tp). (c) inside phase 15 (b), on its
# gemma-2 GraphLM (full width, 42 layers, tied embeddings): one LoRA
# GraphLM.loss and backward without the mesh, then with the model placed
# at ZeRO-3 (the frozen tied embedding under FSDP2, the head reading it
# through LLM.tied_zero). (b) and (c) are gated as phase 20 (b) and (c).
PHASE21 = {"mesh": "dp:1,tp:1", "records": 2, "max_new_tokens": 64,
           "logit_tol": MERGE_LOGIT_TOL, "loss_gap": 1e-3,
           "grad_rel": 1e-2, "leaf_rel": 5e-2}


def _mesh_groups(device, sizes):
    from llamole_tpu_torch.parallel.mesh import MeshGroups, mesh_from_string
    return MeshGroups(mesh_from_string(sizes["mesh"],
                                       torch.device(device).type))


def _is_placed(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def run_quant_molqa(model, tok, kernels, tag, device, sizes=None):
    """Phase 21 (a), on phase 14 (a)'s int8 slice after its serving:
    run_molqa's design without the mesh, then with it (kernel counts from
    0 over the mesh's run). Returns A's launches, the walls and the
    peak."""
    sizes = sizes or PHASE21
    on_card = device == "cuda"
    fused = kernels[0] if kernels else None
    t0 = time.perf_counter()
    plain_designs, mesh_designs = [], []
    want, want_wall = _molqa(model, tok, "", sizes, plain_designs)
    with one_rank_group(device):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        got, got_wall = _molqa(model, tok, sizes["mesh"], sizes,
                               mesh_designs)
        peak = _peak(on_card)
    launches = {"A": getattr(fused, "launches", 0),
                "A_mma": getattr(fused, "launches_mma", 0),
                "A_fma": getattr(fused, "launches_fma", 0)}
    q = model.llm.layers[0].attn["q"]
    placed = _is_placed(q.w_q) and q.quant == "int8"
    same = {
        "analysis tokens": plain_designs == mesh_designs,
        "SMILES": [r["llm_smiles"] for r in want]
        == [r["llm_smiles"] for r in got],
        "responses": [r["llm_response"] for r in want]
        == [r["llm_response"] for r in got]}
    print(f"phase 21 (a) int8 run_molqa on the mesh {sizes['mesh']}: the "
          f"int8 base placed ({'w_q a DTensor' if placed else 'NOT placed'}"
          f"), {len(got)} records at {sizes['max_new_tokens']} new tokens "
          f"{got_wall:.3f} s (without the mesh {want_wall:.3f} s"
          f"{', its decode graphed' if on_card else ''}); equal: {same}; "
          f"A {launches['A']} (mma {launches['A_mma']}, fma "
          f"{launches['A_fma']}) launches; peak {peak} [{tag}]", flush=True)
    if not placed:
        fail("phase 21 (a): the int8 base is not placed on the mesh")
    bad = [k for k, ok in same.items() if not ok]
    if bad:
        fail(f"phase 21 (a): the int8 mesh run differs in {bad}")
    if len(got) != sizes["records"]:
        fail(f"phase 21 (a): run_molqa answered {len(got)} records")
    if on_card:
        check_one_body(fused, "mma", "phase 21 (a) run_molqa on the mesh")
        steps = diffusion_steps(model)
        check_launches("fused_block_attention (phase 21 (a))",
                       launches["A"], model.graph_decoder.cfg.depth * steps,
                       f"{model.graph_decoder.cfg.depth} x {steps} x 1 "
                       "design batch")
    return {**launches, "wall": time.perf_counter() - t0,
            "molqa_s": got_wall, "plain_molqa_s": want_wall, "peak": peak}


@torch.no_grad()
def check_placed_scheme(llm, ids, mask, want, scheme, tag, device,
                        sizes=None):
    """Phase 21 (a), inside phase 14 (b): the scheme's LLM placed on the
    mesh (shard_llm), its prefill's last-position logits against the
    mesh-less ones (want). Returns the gap and the wall."""
    from llamole_tpu_torch.parallel.sharding import shard_llm
    sizes = sizes or PHASE21
    t0 = time.perf_counter()
    with one_rank_group(device):
        shard_llm(llm, _mesh_groups(device, sizes))
        got = llm(input_ids=ids, attention_mask=mask,
                  last_logits_only=True)[0][:, -1]
    gap = _rel(got, want)
    placed = _is_placed(llm.layers[0].attn["o"].w_q)
    print(f"phase 21 (a) {scheme} placed on the mesh {sizes['mesh']} "
          f"({'w_q a DTensor' if placed else 'NOT placed'}): the prefill's "
          f"last-position logits against the mesh-less ones, max |gap| "
          f"over max |logit| {gap:.4e} (limit {sizes['logit_tol']}) "
          f"[{tag}]", flush=True)
    if not placed or not gap <= sizes["logit_tol"]:
        fail(f"phase 21 (a): {scheme} on the mesh strays ({gap})")
    return {"gap": gap, "wall": time.perf_counter() - t0}


def run_qlora_zero3(model, tok, args, start, want, kernels, tag, device,
                    sizes=None):
    """Phase 21 (a), inside phase 14 (d) on its QLoRA model: the
    trainable bundle restored to `start`, run_mmsft (args: (d)'s
    settings) at ZeRO-3 on the mesh; each micro step's loss against (d)'s
    (want). Returns B's and C's launches, the gaps, the wall and the
    peak."""
    from llamole_tpu_torch.config import get_train_args
    from llamole_tpu_torch.train.workflow import run_mmsft
    sizes = sizes or PHASE21
    on_card = device == "cuda"
    out_dir = os.path.join(args["output_dir"], "zero3")
    args = get_train_args({**args, "output_dir": out_dir,
                           "mesh": sizes["mesh"], "zero_stage": 3})
    with torch.no_grad():
        for n, p in model.trainable_parameters().items():
            p.copy_(start[n])
    t0 = time.perf_counter()
    with one_rank_group(device):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts(*kernels)
        run_mmsft(*args, prebuilt=(model, tok))
        peak = _peak(on_card)
        launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                    if on_card else {"B": 0, "C": 0})
    wall = time.perf_counter() - t0
    with open(Path(out_dir) / "trainer_log.jsonl") as f:
        got = [json.loads(line)["loss"] for line in f]
    q = model.llm.layers[0].attn["q"]
    gaps = [abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want)]
    print(f"phase 21 (a) QLoRA at ZeRO-3 on the mesh {sizes['mesh']}: "
          f"losses {[round(x, 6) for x in got]} against phase 14 (d)'s "
          f"{[round(x, 6) for x in want]} (relative gaps "
          f"{[float(f'{g:.3e}') for g in gaps]}, limit {sizes['loss_gap']})"
          f"; the int8 base's buffers in dp chunks "
          f"({'yes' if q.zero is not None else 'NO'}); {wall:.3f} s wall; "
          f"B {launches['B']}, C {launches['C']} launches; peak {peak} "
          f"[{tag}]", flush=True)
    if q.zero is None or not _is_placed(q.w_q):
        fail("phase 21 (a): the QLoRA base is not placed at ZeRO-3")
    if len(got) != len(want) or not all(np.isfinite(got)) or \
            max(gaps) > sizes["loss_gap"]:
        fail(f"phase 21 (a): QLoRA at ZeRO-3 {got} strays from {want}")
    return {**launches, "loss_gaps": gaps, "wall": wall, "peak": peak}


def run_qk_norm_tp(llm, ids, mask, tag, device, sizes=None):
    """Phase 21 (b), on phase 15 (a)'s qwen3 LLM after its decodes:
    freeze-tuned with the per-head q / k norms trainable, one LM loss
    (the prompts' tokens) and backward without the mesh, then with the
    LLM placed on tp. Returns the gaps and the wall."""
    from llamole_tpu_torch.models.gllm.model import lm_loss
    from llamole_tpu_torch.parallel.sharding import shard_llm
    sizes = sizes or PHASE21
    t0 = time.perf_counter()
    for n, p in llm.named_parameters():
        p.requires_grad_(".q_norm." in n or ".k_norm." in n)
    params = {n: p for n, p in llm.named_parameters() if p.requires_grad}
    labels = torch.where(mask > 0, ids, -100)

    def step():
        for p in params.values():
            p.grad = None
        loss = lm_loss(llm(input_ids=ids, attention_mask=mask)[0], labels)
        loss.backward()
        return float(loss.detach()), _grads(params)

    want = step()
    with one_rank_group(device):
        shard_llm(llm, _mesh_groups(device, sizes))
        loss, grads = step()
        out = _gate_step(
            f"phase 21 (b) qwen3 freeze-tuned (the {len(params)} q / k "
            f"norms trainable) on the tp mesh {sizes['mesh']}", loss,
            want[0], grads, want[1], sizes, tag)
    if llm.layers[0].q_norm.tp is None:
        fail("phase 21 (b): the q / k norms have no tp role")
    return {**out, "wall": time.perf_counter() - t0}


def run_tied_zero3(model, batch, kernels, tag, device, sizes=None):
    """Phase 21 (c), on phase 15 (b)'s gemma-2 GraphLM after its serving:
    one LoRA GraphLM.loss and backward without the mesh, then with the
    model placed at ZeRO-3 (the tied embedding under FSDP2). Returns the
    gaps, B's and C's launches and the wall."""
    from torch.distributed.fsdp import FSDPModule
    sizes = sizes or PHASE21
    t0 = time.perf_counter()
    params = model.trainable_parameters()
    for p in params.values():
        p.grad = None
    total, _ = model.loss(batch, torch.Generator(device=device).manual_seed(0),
                          train=True)
    total.backward()
    want = (float(total.detach()), _grads(params))
    del total
    with one_rank_group(device):
        reset_counts(*kernels)
        loss, grads, wall = _mesh_step(model, batch, device, sizes,
                                       zero3=True)
        launches = ({"B": kernels[1].launches, "C": kernels[2].launches}
                    if device == "cuda" else {"B": 0, "C": 0})
        llm = model.llm
        tied = (llm.lm_head is None and llm.tied_zero is not None
                and isinstance(llm.embed, FSDPModule))
        out = _gate_step(
            f"phase 21 (c) gemma-2 LoRA step at ZeRO-3 on the mesh "
            f"{sizes['mesh']} (tied embedding under FSDP2, the head "
            f"gathering it: {tied})", loss, want[0], grads, want[1], sizes,
            tag, f"; loss + backward {wall:.3f} s; B {launches['B']}, C "
                 f"{launches['C']} launches")
    if not tied:
        fail("phase 21 (c): the tied embedding is not under FSDP2")
    if device == "cuda":
        layers = model.graph_predictor.cfg.num_layer
        check_launches("gin_aggregate (phase 21 (c))", launches["B"], layers,
                       f"{layers} predictor layers")
        check_launches("gin_aggregate_backward (phase 21 (c))",
                       launches["C"], layers - 1,
                       f"{layers - 1} predictor layers")
    return {**out, **launches, "wall": time.perf_counter() - t0}


def run_ring(tag, device="cuda", sizes=None):
    """Phase 20 (a): ring_attention on the world-size-1 sp group against
    the plain causal attention (gllm attention: f32 logits, probabilities
    in bf16 before the value product), forward and backward, in turns
    (plain, ring, ring, plain). Returns the gaps and the walls."""
    from llamole_tpu_torch.models.gllm.model import attention
    from llamole_tpu_torch.ops.ring_attention import ring_attention
    sizes = sizes or PHASE20
    t_part = time.perf_counter()
    b, s, h, d = (sizes[k] for k in ("batch", "seq", "heads", "head_dim"))
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, cot = (torch.randn((b, s, h, d), generator=gen, device=device)
                    .to(torch.bfloat16) for _ in range(4))
    mask = torch.ones((b, s), dtype=torch.int32, device=device)
    mask[:, s - sizes["padded"]:] = 0
    allowed = (torch.ones((s, s), dtype=torch.bool, device=device).tril()[None]
               & (mask > 0)[:, None, :])
    with one_rank_group(device) as group:
        runs = {}
        for kind in ("plain", "ring", "ring", "plain"):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            _sync_card()
            t0 = time.perf_counter()
            if kind == "ring":
                out = ring_attention(*leaves, mask, group)
            else:
                out = attention(*leaves, allowed).view(b, s, h, d)
            out.backward(cot)
            _sync_card()
            wall = time.perf_counter() - t0
            runs.setdefault(kind, {"out": out.detach().float(),
                                   "grads": [t.grad.float()
                                             for t in leaves],
                                   "walls": [], "peak": _peak(
                                       device == "cuda")})
            runs[kind]["walls"].append(wall)
            del out, leaves
    ring, plain = runs["ring"], runs["plain"]
    out_gap = _rel(ring["out"], plain["out"])
    grad_gaps = [_rel_l2(g, w) for g, w in zip(ring["grads"], plain["grads"])]
    print(f"phase 20 (a) ring_attention on the world-size-1 sp group at "
          f"[{b}, {s}, {h}, {d}] bf16, the last {sizes['padded']} keys "
          f"padded: output max |gap| / max |plain| {out_gap:.3e} (limit "
          f"{sizes['ring_out']}), dq / dk / dv relative L2 gaps "
          f"{', '.join(f'{g:.3e}' for g in grad_gaps)} (limit "
          f"{sizes['ring_grad']}); forward + backward in turns: ring "
          f"{[round(w, 4) for w in ring['walls']]} s (peak {ring['peak']}), "
          f"plain {[round(w, 4) for w in plain['walls']]} s (peak "
          f"{plain['peak']}) [{tag}]", flush=True)
    if not torch.isfinite(ring["out"]).all() or out_gap > sizes["ring_out"]:
        fail(f"phase 20 (a): the ring's output strays ({out_gap})")
    if max(grad_gaps) > sizes["ring_grad"]:
        fail(f"phase 20 (a): the ring's gradients stray ({grad_gaps})")
    return {"out_gap": out_gap, "grad_gaps": grad_gaps,
            "ring_s": min(ring["walls"]), "plain_s": min(plain["walls"]),
            "wall": time.perf_counter() - t_part}


# Phase 22: kernel E (the LLM's flash route, use_flash) on phase 9's model.
# checks: (B, S, H, KV, D, dtype) held to flash_attention_reference, row 0
# left-padded by left_pad and the last row right-padded by right_pad (a
# single row both). f32: each output within f32_atol of the plain version.
# bf16: an absolute limit cannot hold, since dk and dv reach ~8 at S = 2048,
# where one bf16 step is 3.1e-2 and the plain version in bf16 is itself
# 2.8e-2 from the exact result; and one relative to the largest value
# misses a fault on the later rows, whose values are ~0.05. So out, dq, dk
# and dv are held to the plain version in f32 on the same bf16 inputs
# ("exact"), tile by tile of 64 positions of a head: max |kernel - exact|
# within bf16_gap x max |plain - exact| (the plain version has jaxlib's
# rounding points, as the kernel has) plus one bf16 step of the tile's
# largest |exact| (flash_gate). main: the shape timed, the 8B's attention
# at the training step's length; train_seq / long_seq: the micro steps of
# (b) and (c); loss_gap (of the loss) and grad_rel (relative L2 of the
# LoRA gradients as one vector): how far (b)'s and (d)'s flash steps may be
# from their plain ones. The head_dim-256 checks are gemma-7b's heads (16
# of 256, one KV head each), timed at S = 1024 (time_flash_wide), the same
# with two query heads a KV head, and gemma-7b's heads at (d)'s length,
# the shape (d)'s step sends the kernels.
# gemma7b: (d)'s and (f)'s model, the published google/gemma-7b
# config.json (Hugging Face) as from_hf_config reads it,
# tie_word_embeddings written out (HF's default for gemma, which the file
# leaves out); gemma_layers: the depth (d) and (f) run it at. The f32
# checks are the 8B's heads and 16 query heads of 256 on 8 KV heads, at
# S = 1024 (the split-TF32 bodies at both head dims). f32_seq,
# f32_loss_gap (of the loss), f32_grad_rel: (e)'s and (f)'s steps, the 8B
# and gemma-7b in f32 (what fp16: true builds), and how far their flash
# steps may be from their plain ones: both f32, so far tighter than bf16's
PHASE22 = {"checks": ((1, 2048, 32, 8, 128, "bf16"),
                      (2, 1024, 32, 8, 128, "bf16"),
                      (1, 1024, 16, 16, 256, "bf16"),
                      (1, 1024, 16, 8, 256, "bf16"),
                      (1, 2048, 16, 16, 256, "bf16"),
                      (1, 1024, 32, 8, 128, "f32"),
                      (1, 1024, 16, 8, 256, "f32")),
           "main": (1, 2048, 32, 8, 128), "left_pad": 37, "right_pad": 301,
           "f32_atol": TOL[torch.float32], "bf16_gap": 2.0,
           "train_seq": 2048, "long_seq": 4096, "loss_gap": 5e-2,
           "grad_rel": 5e-2,
           "gemma7b": {"model_type": "gemma", "vocab_size": 256000,
                       "hidden_size": 3072, "intermediate_size": 24576,
                       "num_hidden_layers": 28, "num_attention_heads": 16,
                       "num_key_value_heads": 16, "head_dim": 256,
                       "hidden_act": "gelu", "rms_norm_eps": 1e-6,
                       "rope_theta": 10000.0,
                       "max_position_embeddings": 8192,
                       "attention_bias": False, "rope_scaling": None,
                       "tie_word_embeddings": True},
           "gemma_layers": 28, "f32_seq": 1024, "f32_loss_gap": 1e-4,
           "f32_grad_rel": 1e-3}
FLASH_COUNTS = ("launches_fwd", "launches_dq", "launches_dkv")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def flash_inputs(shape, dtype, sizes, device="cuda", seed=0):
    """Seeded q, k, v, dO and segment ids (the attention mask): row 0
    left-padded, the last row right-padded."""
    b, s, h, kv, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*dims):
        return torch.randn(dims, generator=gen, device=device).to(dtype)

    q, k, v, dout = (draw(b, s, h, d), draw(b, s, kv, d), draw(b, s, kv, d),
                     draw(b, s, h * d))
    seg = torch.ones((b, s), dtype=torch.int32, device=device)
    seg[0, :sizes["left_pad"]] = 0
    seg[-1, s - sizes["right_pad"]:] = 0
    return q, k, v, dout, seg


def flash_allowed(seg):
    """[B, S, S]: query i attends key j iff j <= i in the same segment."""
    s = seg.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device=seg.device).tril()
    return causal[None] & (seg[:, :, None] == seg[:, None, :])


def flash_bound(shape, dtype, pairs, backward):
    """Kernel E: each input read once and each output written once --
    forward: q, k and v (GQA's KV heads, not a copy per query head), the
    segment ids, the output and the f32 log-sum-exp; backward: q, k, v,
    the segment ids, out, dO and the log-sum-exp read, dq, dk, dv written
    -- and the products over the pairs this run's segment ids attend
    (`pairs` a row: causal and same-segment), two in the forward (q.k,
    P.v) and five in the backward (q.k again, dO.v, P.dO, dS.q, dS.k), on
    the tensor cores (bf16) or the f32 units, with ~6 f32 operations a
    pair and head (scale and mask, max, exp, sums)."""
    b, s, h, kv, d = shape
    size = torch.tensor([], dtype=dtype).element_size()
    q_bytes, kv_bytes = b * s * h * d * size, b * s * kv * d * size
    small = b * s * 4 + b * h * s * 4              # segment ids, lse
    if backward:
        nbytes = 4 * q_bytes + 4 * kv_bytes + small
    else:
        nbytes = 2 * q_bytes + 2 * kv_bytes + small
    mm = (5 if backward else 2) * 2 * h * d * pairs
    kind = "bf16_tensor" if dtype == torch.bfloat16 else "f32_tensor"
    return roofline(nbytes, {kind: mm, "f32": 6 * h * pairs})


def bf16_step(x):
    """One bf16 step (a unit in the last of its 8 significant bits) at
    each |x|: 2^(e - 8) for |x| in [2^(e - 1), 2^e)."""
    _, exp = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), exp - 8)


def flash_gate(got, plain, exact, d, gap, tile=64):
    """The bf16 check of one output ([B, S, heads * D] or [B, S, heads,
    D]): over each tile of `tile` positions of one head, max |got - exact|
    / (gap x max |plain - exact| + one bf16 step of the tile's largest
    |exact|); the worst tile's, above 1 failing. A tile, not a row: a
    row's own rounding error swings with the few terms that dominate it
    (a segment's first query, one key, cancels to f32 noise), a tile's
    maximum does not, and a fault on a key or query tile still fills
    one."""
    def tiles(t):
        return t.float().reshape(t.shape[0], t.shape[1] // tile, tile, -1, d)
    amax = lambda t: t.abs().amax(dim=(2, 4))
    e = tiles(exact)
    limit = gap * amax(tiles(plain) - e) + bf16_step(amax(e))
    return float((amax(tiles(got) - e) / limit).max())


def _flash_grads(fn, q, k, v, dout, seg):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, seg)
    return (out.detach(),
            list(torch.autograd.grad(out, leaves, dout)))


def check_flash_outputs(got, want, exact, shape, name, sizes):
    """One check's gate over out, dq, dk, dv (kernel, plain version and,
    in bf16, the plain version in f32 on the same inputs): prints the
    readings, fails past the limits, returns the largest |kernel - plain|."""
    names = ("out", "dq", "dk", "dv")
    d = shape[-1]
    for g in got:
        if not torch.isfinite(g).all():
            fail(f"kernel E at {shape} {name}: an output is not finite")
    gaps = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)]
    head = (f"flash_attention check (B, S, H, KV, D)={tuple(shape)} {name} "
            f"(row 0 left-padded by {sizes['left_pad']}, the last row "
            f"right-padded by {sizes['right_pad']}): max |kernel - plain| "
            "(max |plain|) "
            + ", ".join(f"{n} {g:.3e} ({float(w.float().abs().max()):.3e})"
                        for n, g, w in zip(names, gaps, want)))
    if exact is None:
        print(f"{head} (limit {sizes['f32_atol']:g})", flush=True)
        if not max(gaps) <= sizes["f32_atol"]:
            fail(f"kernel E disagrees at {shape} {name}: {gaps}")
        return max(gaps)
    ratios = [flash_gate(g, w, x, d, sizes["bf16_gap"])
              for g, w, x in zip(got, want, exact)]
    off = [(float((g.float() - x).abs().max()),
            float((w.float() - x).abs().max()))
           for g, w, x in zip(got, want, exact)]
    print(f"{head}; max |kernel - f32| / max |plain - f32|: "
          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, (a, b) in zip(names,
                                                                     off))
          + "; the worst tile's (64 positions of a head) max |kernel - f32| "
          f"over ({sizes['bf16_gap']:g} x max |plain - f32| + one bf16 step "
          "of max |f32|), limit 1: "
          + ", ".join(f"{n} {r:.3f}" for n, r in zip(names, ratios)),
          flush=True)
    if not max(ratios) <= 1.0:
        fail(f"kernel E disagrees at {shape} {name}: worst tiles "
             f"{dict(zip(names, ratios))}")
    return max(gaps)


def check_flash(flash, reference, tag, sizes=None):
    """Phase 22 (a): kernel E's forward, dq and dkv kernels against
    flash_attention_reference at sizes["checks"] (output and dq / dk / dv,
    padded rows included; the limits at PHASE22); at the main shape two
    backward runs bit-equal, then times: call ms (CUDA events) of the
    forward and of forward + backward, each kernel's device ms from
    CUDA-graph replay of its launcher (device time plus the gaps between
    launches, an upper bound), the plain version's,
    F.scaled_dot_product_attention's with the [B, 1, S, S] segment mask
    (the one PyTorch call of the same function; its call ms and, by the
    same graph replay, its device ms, the backward as forward + backward
    less the forward) and, as a floor, causal with no segments on the
    same tensors; the bound of each half. Returns the record of E's JSON
    entry."""
    import torch.nn.functional as F
    from llamole_tpu_torch.ops import flash_attention as E
    sizes = sizes or PHASE22
    errs = {"bf16": 0.0, "f32": 0.0}
    for *shape, name in sizes["checks"]:
        dt = DTYPES[name]
        q, k, v, dout, seg = flash_inputs(shape, dt, sizes)
        out, grads = _flash_grads(flash, q, k, v, dout, seg)
        torch.cuda.synchronize()
        ref, ref_grads = _flash_grads(reference, q, k, v, dout, seg)
        exact = None
        if dt != torch.float32:
            exact = _flash_grads(reference,
                                 *(t.float() for t in (q, k, v, dout)), seg)
            exact = (exact[0], *exact[1])
        errs[name] = max(errs[name], check_flash_outputs(
            (out, *grads), (ref, *ref_grads), exact, shape, name, sizes))
        del q, k, v, dout, out, grads, ref, ref_grads, exact

    shape = sizes["main"]
    dt = torch.bfloat16
    wide = [tuple(c[:5]) for c in sizes["checks"]
            if c[4] == 256 and c[5] == "bf16"]
    f32 = [tuple(c[:5]) for c in sizes["checks"] if c[5] == "f32"]
    same = [(bits, dt) for bits in (shape, *wide)] + [
        (bits, torch.float32) for bits in f32]
    for bits, kind in same:
        q, k, v, dout, seg = flash_inputs(bits, kind, sizes)
        first = _flash_grads(flash, q, k, v, dout, seg)[1]
        again = _flash_grads(flash, q, k, v, dout, seg)[1]
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"kernel E's backward at {bits} {kind} gave other bits on "
                 "a second run")
        del q, k, v, dout, seg, first, again
    print(f"flash_attention backward: two runs bit-equal at "
          f"{[shape, *wide]} bf16 and {f32} f32", flush=True)
    q, k, v, dout, seg = flash_inputs(shape, dt, sizes)

    timed_pair = lambda fn, layout=lambda t: t, grad_out=dout: (
        flash_timed_pair(fn, [layout(t) for t in (q, k, v)], grad_out))
    kernel = timed_pair(lambda a, b, c: flash(a, b, c, seg))
    plain = timed_pair(lambda a, b, c: reference(a, b, c, seg))
    rec = {"ms": cuda_ms(kernel[1]), "fwd_ms": cuda_ms(kernel[0]),
           "plain_ms": cuda_ms(plain[1], launches=5, repeats=5),
           "plain_fwd_ms": cuda_ms(plain[0], launches=5, repeats=5)}
    out, lse = E.flash_forward(q, k, v, seg)
    _, delta = E.flash_backward_dq(q, k, v, seg, out, dout, lse)
    rec["fwd_device_ms"] = graph_ms(lambda: E.flash_forward(q, k, v, seg))
    rec["dq_device_ms"] = graph_ms(lambda: E.flash_backward_dq(
        q, k, v, seg, out, dout, lse))
    rec["dkv_device_ms"] = graph_ms(lambda: E.flash_backward_dkv(
        q, k, v, seg, dout, lse, delta))
    rec["bwd_device_ms"] = rec["dq_device_ms"] + rec["dkv_device_ms"]
    rec["device_ms"] = rec["fwd_device_ms"] + rec["bwd_device_ms"]
    rec["device_from"] = "CUDA-graph replay of each launcher"
    del out, lse, delta
    # SDPA in its [B, H, S, D] layout, the GQA heads expanded by the call
    bhsd, dout_t, mask = sdpa_layout(shape, dout, seg)
    for key in ("library_ms", "library_fwd_ms", "library_device_ms",
                "library_fwd_device_ms", "sdpa_causal_ms",
                "sdpa_causal_fwd_ms"):
        rec[key] = None
    try:
        lib = timed_pair(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, enable_gqa=True), bhsd, dout_t)
        rec["library_ms"], rec["library_fwd_ms"] = (cuda_ms(lib[1]),
                                                    cuda_ms(lib[0]))
        floor = timed_pair(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True), bhsd, dout_t)
        rec["sdpa_causal_ms"], rec["sdpa_causal_fwd_ms"] = (
            cuda_ms(floor[1]), cuda_ms(floor[0]))
    except RuntimeError as exc:  # a yardstick only: the port never calls it
        print(f"F.scaled_dot_product_attention not timed: {exc}", flush=True)
    if rec["library_ms"] is not None:
        try:  # its device time on E's terms: graph replay, halves apart
            rec["library_fwd_device_ms"] = graph_ms(lib[0])
            rec["library_device_ms"] = graph_ms(lib[1])
        except RuntimeError as exc:
            rec["library_fwd_device_ms"] = rec["library_device_ms"] = None
            print(f"SDPA's graph capture failed, its device time not "
                  f"measured: {exc}", flush=True)
    diff = lambda a, b: None if a is None or b is None else a - b
    rec["bwd_ms"] = rec["ms"] - rec["fwd_ms"]
    rec["library_bwd_ms"] = diff(rec["library_ms"], rec["library_fwd_ms"])
    rec["library_bwd_device_ms"] = diff(rec["library_device_ms"],
                                        rec["library_fwd_device_ms"])
    pairs = int(flash_allowed(seg).sum())
    fwd_bound = flash_bound(shape, dt, pairs, backward=False)
    bwd_bound = flash_bound(shape, dt, pairs, backward=True)
    rec.update(fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
               bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1],
               bound_ms=fwd_bound[0] + bwd_bound[0],
               bound_by=("operations" if "operations" in (fwd_bound[1],
                                                           bwd_bound[1])
                         else "bytes"),
               pairs=pairs, shape=list(shape), max_abs_err=errs["bf16"],
               f32_max_abs_err=errs["f32"],
               share=(fwd_bound[0] + bwd_bound[0]) / rec["device_ms"],
               fwd_share=fwd_bound[0] / rec["fwd_device_ms"],
               bwd_share=bwd_bound[0] / rec["bwd_device_ms"],
               fwd_body={str(d): E.forward_body(dt, d) for d in E.HEAD_DIMS},
               bwd_body={str(d): E.backward_body(dt, d) for d in E.HEAD_DIMS})
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    print(f"flash_attention at (B, S, H, KV, D)={shape} bf16, {pairs} "
          f"attended pairs a head (device times from {rec['device_from']}"
          f"): forward call {rec['fwd_ms']:.4f} ms, device "
          f"{rec['fwd_device_ms']:.4f} ms, bound {1e3 * fwd_bound[0]:.2f} "
          f"us ({fwd_bound[1]}), share {rec['fwd_share']:.4f}; backward "
          f"device {rec['bwd_device_ms']:.4f} ms (dq "
          f"{rec['dq_device_ms']:.4f} + dkv {rec['dkv_device_ms']:.4f}), "
          f"bound {1e3 * bwd_bound[0]:.2f} us ({bwd_bound[1]}), share "
          f"{rec['bwd_share']:.4f}; forward + backward call "
          f"{rec['ms']:.4f} ms; backward call E {rec['bwd_ms']:.4f} ms, "
          f"SDPA with the segment mask {fmt(rec['library_bwd_ms'])} ms; "
          f"backward device E {rec['bwd_device_ms']:.4f} ms, SDPA "
          f"{fmt(rec['library_bwd_device_ms'])} ms; plain version "
          f"{rec['plain_fwd_ms']:.4f} / {rec['plain_ms']:.4f} ms (forward / "
          f"forward + backward); SDPA with the segment mask call "
          f"{fmt(rec['library_fwd_ms'])} / {fmt(rec['library_ms'])} ms, "
          f"device {fmt(rec['library_fwd_device_ms'])} / "
          f"{fmt(rec['library_device_ms'])} ms; SDPA causal without "
          f"segments (a floor) {fmt(rec['sdpa_causal_fwd_ms'])} / "
          f"{fmt(rec['sdpa_causal_ms'])} ms [{tag}]", flush=True)
    del q, k, v, dout, seg, kernel, plain
    rec["d256"] = time_flash_wide(wide[0], dt, sizes, tag)
    rec["f32"] = time_flash_wide(f32[0], torch.float32, sizes, tag)
    rec["f32_d256"] = time_flash_wide(f32[1], torch.float32, sizes, tag)
    rec["f32_bwd_body"] = {str(d): E.backward_body(torch.float32, d)
                           for d in E.HEAD_DIMS}
    return rec


def flash_timed_pair(fn, ins, grad_out):
    """(forward without autograd, forward + backward) of fn(*ins)."""
    req = [t.clone().requires_grad_(True) for t in ins]

    def fwd():
        with torch.no_grad():
            return fn(*ins)

    def step():
        out = fn(*req)
        return torch.autograd.grad(out, req, grad_out)
    return fwd, step


def sdpa_layout(shape, dout, seg):
    """F.scaled_dot_product_attention's [B, H, S, D] layout of E's inputs:
    the transpose, dO in it, and the [B, 1, S, S] segment mask."""
    b, s, h, _, d = shape
    bhsd = lambda t: t.transpose(1, 2).contiguous()
    return (bhsd, dout.reshape(b, s, h, d).transpose(1, 2).contiguous(),
            flash_allowed(seg)[:, None])


def time_flash_wide(shape, dt, sizes, tag):
    """Kernel E at one more shape in dt on flash_inputs' padding at sizes'
    left_pad / right_pad (bf16 at head_dim 256, gemma's heads, padded as
    the checks are and, for (d), at its step's shape with no padding;
    f32 at both head dims, every body in split TF32, and for (e) and (f)
    at their steps' shapes): the forward's and
    each backward kernel's device ms by CUDA-graph replay of its
    launcher, each half's flash_bound and share, the call ms (CUDA
    events) of the forward and of forward + backward through
    flash_attention, the plain version's forward + backward, and
    SDPA-with-mask's call ms and device ms (the forward and the backward
    apart; None where it cannot run or be captured), with the bodies'
    names. In f32 the card's TF32 setting is recorded beside SDPA's
    times (main() turns it off), and each time is taken over 5 x 5
    calls (they last up to milliseconds; the script's time limit)."""
    import torch.nn.functional as F
    from llamole_tpu_torch.ops import flash_attention as E
    d = shape[-1]
    reps = {} if dt == torch.bfloat16 else {"launches": 5, "repeats": 5}
    q, k, v, dout, seg = flash_inputs(shape, dt, sizes)
    out, lse = E.flash_forward(q, k, v, seg)
    _, delta = E.flash_backward_dq(q, k, v, seg, out, dout, lse)
    rec = {"shape": list(shape), "dtype": str(dt).split(".")[-1],
           "pads": [sizes["left_pad"], sizes["right_pad"]],
           "fwd_body": E.forward_body(dt, d), "bwd_body": E.backward_body(dt, d),
           "fwd_device_ms": graph_ms(lambda: E.flash_forward(q, k, v, seg),
                                     **reps),
           "dq_device_ms": graph_ms(lambda: E.flash_backward_dq(
               q, k, v, seg, out, dout, lse), **reps),
           "dkv_device_ms": graph_ms(lambda: E.flash_backward_dkv(
               q, k, v, seg, dout, lse, delta), **reps),
           "library_fwd_ms": None, "library_ms": None,
           "library_fwd_device_ms": None, "library_bwd_device_ms": None,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    del out, lse, delta
    rec["bwd_device_ms"] = rec["dq_device_ms"] + rec["dkv_device_ms"]
    pairs = int(flash_allowed(seg).sum())
    for half, backward in (("fwd", False), ("bwd", True)):
        bound, by = flash_bound(shape, dt, pairs, backward)
        rec.update({f"{half}_bound_ms": bound, f"{half}_bound_by": by,
                    f"{half}_share": bound / rec[f"{half}_device_ms"]})
    rec["pairs"] = pairs
    kernel = flash_timed_pair(lambda a, b, c: E.flash_attention(a, b, c, seg),
                              [q, k, v], dout)
    plain = flash_timed_pair(
        lambda a, b, c: E.flash_attention_reference(a, b, c, seg), [q, k, v],
        dout)
    rec.update(fwd_ms=cuda_ms(kernel[0], **reps),
               ms=cuda_ms(kernel[1], **reps),
               plain_ms=cuda_ms(plain[1], launches=5, repeats=5))
    del kernel, plain
    bhsd, dout_t, mask = sdpa_layout(shape, dout, seg)
    try:
        lib = flash_timed_pair(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, enable_gqa=True),
            [bhsd(t) for t in (q, k, v)], dout_t)
        rec["library_fwd_ms"], rec["library_ms"] = (cuda_ms(lib[0], **reps),
                                                    cuda_ms(lib[1], **reps))
        rec["library_fwd_device_ms"] = graph_ms(lib[0], **reps)
        rec["library_bwd_device_ms"] = (graph_ms(lib[1], **reps)
                                        - rec["library_fwd_device_ms"])
    except RuntimeError as exc:  # a yardstick only: the port never calls it
        print(f"SDPA at {shape} not timed: {exc}", flush=True)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    print(f"flash_attention at (B, S, H, KV, D)={shape} {rec['dtype']} "
          f"(row 0 left-padded by {sizes['left_pad']}, the last row "
          f"right-padded by {sizes['right_pad']}), "
          f"{pairs} attended pairs a head (device times from CUDA-graph "
          f"replay of each launcher; the forward on its {rec['fwd_body']} "
          f"body, dq and dkv on their {rec['bwd_body']} bodies): forward "
          f"{rec['fwd_device_ms']:.4f} ms, bound "
          f"{1e3 * rec['fwd_bound_ms']:.2f} us, share {rec['fwd_share']:.4f}; "
          f"backward {rec['bwd_device_ms']:.4f} ms (dq "
          f"{rec['dq_device_ms']:.4f} + dkv {rec['dkv_device_ms']:.4f}), "
          f"bound {1e3 * rec['bwd_bound_ms']:.2f} us ({rec['bwd_bound_by']}), "
          f"share {rec['bwd_share']:.4f}; call forward {rec['fwd_ms']:.4f} / "
          f"forward + backward {rec['ms']:.4f} ms, plain version forward + "
          f"backward {rec['plain_ms']:.4f} ms; SDPA with the segment mask "
          f"device {fmt(rec['library_fwd_device_ms'])} / "
          f"{fmt(rec['library_bwd_device_ms'])} ms (forward / backward), "
          f"call {fmt(rec['library_fwd_ms'])} / {fmt(rec['library_ms'])} ms "
          f"(forward / forward + backward; TF32 "
          f"{'on' if rec['allow_tf32'] else 'off'}) [{tag}]", flush=True)
    return rec


def flash_lm_batch(vocab, length, device, seed=0):
    """[1, length] token ids drawn from a seed, every one real and its own
    label: the causal-LM loss reads every position, so E's backward
    carries gradient on every key tile."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (1, length), generator=gen).to(device)
    return {"input_ids": ids, "attention_mask": torch.ones_like(ids),
            "labels": ids}


def flash_train_batch(tok, length):
    """The first record of data/molqa_train_examples.json collated as
    run_mmsft collates it (phase 9's llama3 template and cutoff), padded
    on the right to `length` tokens: a [1, length] batch."""
    from llamole_tpu_torch.data.collator import SeqGraphCollator
    from llamole_tpu_torch.data.loader import get_dataset

    data_args = SimpleNamespace(
        dataset="molqa_train_examples",
        dataset_dir=str(Path(__file__).resolve().parent / "data"),
        max_samples=None, template="llama3", learned_query_size=8,
        cutoff_len=2048, train_on_prompt=False)
    bank, inputs = get_dataset(None, data_args, None, tok)
    collate = SeqGraphCollator(tokenizer=tok, mol_id_to_graph=bank,
                               max_len=length, max_nodes=MAX_NODES,
                               max_graphs=16, max_retro=16,
                               pad_to_multiple_of=length)
    return collate(inputs[:1])


@contextlib.contextmanager
def counted_plain_attention(log):
    """Count the LLM's plain attention calls in log["plain"]."""
    from llamole_tpu_torch.models.gllm import model as gllm
    plain = gllm.attention

    def counted(*args, **kwargs):
        log["plain"] += 1
        return plain(*args, **kwargs)
    gllm.attention = counted
    try:
        yield
    finally:
        gllm.attention = plain


def lm_step_loss(model, batch):
    """The LLM's causal-LM loss through LLM.forward(train=True)."""
    from llamole_tpu_torch.models.gllm.model import lm_loss
    from llamole_tpu_torch.utils.constants import IGNORE_INDEX
    logits, _, _ = model.llm(input_ids=batch["input_ids"],
                             attention_mask=batch["attention_mask"],
                             train=True)
    loss = lm_loss(logits, batch["labels"], IGNORE_INDEX)
    return loss, loss


def graph_lm_step_loss(model, batch):
    """GraphLM.loss, the loss run_mmsft takes, and its LM part."""
    gen = torch.Generator(device=model.llm.device).manual_seed(0)
    total, parts = model.loss(batch, gen)
    return total, parts["lm_loss"]


def flash_step(model, batch, use_flash, device, loss_fn=lm_step_loss):
    """One loss_fn forward + backward (no update) with the LLM's use_flash
    set: the losses, the LoRA gradients, the wall, the peak and the
    kernel-E and plain-attention calls."""
    from llamole_tpu_torch.ops import flash_attention as E
    llm = model.llm
    on_card = device == "cuda"
    for p in model.parameters():
        p.grad = None
    E.reset_launches()
    log = {"plain": 0}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    llm.cfg.use_flash = use_flash
    try:
        with counted_plain_attention(log):
            _sync_card()
            t0 = time.perf_counter()
            total, lm = loss_fn(model, batch)
            total.backward()
            _sync_card()
            wall = time.perf_counter() - t0
    finally:
        llm.cfg.use_flash = False
    grads = torch.cat([p.grad.float().reshape(-1)
                       for n, p in sorted(model.named_parameters())
                       if "lora_" in n and p.grad is not None])
    for p in model.parameters():
        p.grad = None
    return {"loss": float(total.detach()), "lm_loss": float(lm.detach()),
            "grads": grads, "wall": wall, "peak": _peak(on_card),
            "plain": log["plain"],
            **{k: getattr(E.flash_attention, k) for k in FLASH_COUNTS}}


def flash_pair(model, batch, device, sizes, loss_fn, order, what, need,
               tag):
    """loss_fn's step with use_flash off and on in `order` (each True /
    False; the walls the faster of each kind, the losses and gradients
    the first's), held: the losses within loss_gap of the loss, the LoRA
    gradients within grad_rel, the flash steps on kernel E in every layer
    (`need` launches of each kernel, on the card) and never on the plain
    attention."""
    runs = {True: [], False: []}
    for on in order:
        runs[on].append(flash_step(model, batch, on, device, loss_fn))
    plain, flash = runs[False][0], runs[True][0]
    for run, kind in ((plain, False), (flash, True)):
        run["walls"] = [r["wall"] for r in runs[kind]]
        run["wall"] = min(run["walls"])
    gap = abs(flash["loss"] - plain["loss"])
    rel = _rel_l2(flash["grads"], plain["grads"])
    real = int(batch["attention_mask"].sum())
    print(f"phase 22 {what} at [1, {batch['input_ids'].shape[1]}] ({real} "
          f"real tokens): loss plain {plain['loss']:.6f} (lm "
          f"{plain['lm_loss']:.6f}), flash {flash['loss']:.6f} (lm "
          f"{flash['lm_loss']:.6f}), gap {gap:.3e} (limit "
          f"{sizes['loss_gap']} x loss); LoRA gradients relative L2 "
          f"{rel:.3e} (limit {sizes['grad_rel']}); walls plain "
          f"{[round(w, 3) for w in plain['walls']]} s, flash "
          f"{[round(w, 3) for w in flash['walls']]} s; peak plain "
          f"{plain['peak']}, flash {flash['peak']}; kernel E launches "
          f"forward {flash['launches_fwd']}, dq {flash['launches_dq']}, dkv "
          f"{flash['launches_dkv']} (need {need['launches_fwd']}, "
          f"{need['launches_dq']}, {need['launches_dkv']}), plain "
          f"attention calls {flash['plain']} (plain step {plain['plain']}) "
          f"[{tag}]", flush=True)
    if not (np.isfinite(flash["loss"])
            and gap <= sizes["loss_gap"] * abs(plain["loss"])):
        fail(f"phase 22 {what}: the flash loss {flash['loss']} strays from "
             f"the plain {plain['loss']}")
    if not rel < sizes["grad_rel"]:
        fail(f"phase 22 {what}: the LoRA gradients stray ({rel})")
    if flash["plain"] or (device == "cuda" and any(
            flash[k] != n for k, n in need.items())):
        fail(f"phase 22 {what}: not every layer ran kernel E ({flash})")
    del plain["grads"], flash["grads"]
    return {"plain": plain, "flash": flash, "loss_gap": gap,
            "grad_rel": rel}


def run_flash(model, tok, tag, device="cuda", sizes=None):
    """Phase 22 on phase 9's model: (a) check_flash on the card; (b) one
    training micro step of the LLM's causal-LM loss (LLM.forward(train=
    True)) at [1, train_seq] on real tokens only, with use_flash off and
    on in turns (flash_pair); then GraphLM.loss, the loss run_mmsft takes,
    on the first training record collated with a right-padded tail to the
    same length, flash on and off (the loss reads the record's tokens
    only); (c) the causal-LM step at [1, long_seq] with use_flash, where
    the plain attention's saved probabilities would not fit. Returns E's
    JSON record and the parts' walls."""
    from llamole_tpu_torch.ops import flash_attention as E
    sizes = sizes or PHASE22
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    rec = (check_flash(E.flash_attention, E.flash_attention_reference, tag,
                       sizes) if on_card else {})
    t_a = time.perf_counter() - t_phase
    cfg = model.llm.cfg
    layers = cfg.num_layers
    need = {"launches_fwd": layers * (2 if cfg.remat else 1),
            "launches_dq": layers, "launches_dkv": layers}
    train = flash_pair(model, flash_lm_batch(cfg.vocab_size,
                                             sizes["train_seq"], device),
                       device, sizes, lm_step_loss,
                       (False, True, True, False),
                       "(b) causal-LM loss + backward", need, tag)
    padded = flash_pair(model, flash_train_batch(tok, sizes["train_seq"]),
                        device, sizes, graph_lm_step_loss, (True, False),
                        "(b) GraphLM.loss + backward, a right-padded tail,",
                        need, tag)
    t_b = time.perf_counter() - t_phase - t_a
    long = flash_step(model, flash_lm_batch(cfg.vocab_size,
                                            sizes["long_seq"], device),
                      True, device)
    print(f"phase 22 (c) causal-LM loss + backward at [1, "
          f"{sizes['long_seq']}] ({sizes['long_seq']} real tokens) with "
          f"use_flash: loss {long['loss']:.6f}, wall {long['wall']:.3f} s, "
          f"peak {long['peak']}; kernel E launches forward "
          f"{long['launches_fwd']}, dq {long['launches_dq']}, dkv "
          f"{long['launches_dkv']}, plain attention calls {long['plain']} "
          f"[{tag}]", flush=True)
    if (not np.isfinite(long["loss"]) or long["plain"]
            or (on_card and any(long[k] != n for k, n in need.items()))):
        fail(f"phase 22 (c): {long}")
    del long["grads"]
    t_c = time.perf_counter() - t_phase - t_a - t_b
    return {**rec, "train": train, "padded": padded, "long": long,
            "walls": {"a": t_a, "b": t_b, "c": t_c}}


def flash_model_pair(cfg, dtype, part, what, seq, sizes, tag, device,
                     build):
    """Phase 22 (d) and (e): cfg's LLM in `dtype`, random weights
    (family_llm) in a rank-8 LoRA GraphLM (build), run once phase 9's
    slice is freed; the causal-LM loss + backward on [1, seq] seeded real
    tokens with use_flash off and on in turns (flash_pair under sizes'
    loss_gap and grad_rel: every layer on kernel E, no plain attention
    call), then, on the card, E at the step's shape with every token real
    (time_flash_wide), its kernels' time inside the step each kernel's
    launches x its replay ms. Returns flash_pair's record, the timing
    record, the in-step kernel ms and the part's wall."""
    t0 = time.perf_counter()
    model, _ = build(family_llm(cfg, device, dtype=dtype))
    layers = cfg.num_layers
    need = {"launches_fwd": layers * (2 if cfg.remat else 1),
            "launches_dq": layers, "launches_dkv": layers}
    batch = flash_lm_batch(cfg.vocab_size, seq, device)
    pair = flash_pair(model, batch, device, sizes, lm_step_loss,
                      (False, True, True, False),
                      f"({part}) {what} causal-LM loss + backward", need, tag)
    del model, batch
    gc.collect()
    timed, kernels = {}, {}
    if device == "cuda":
        torch.cuda.empty_cache()
        shape = (1, seq, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
        timed = time_flash_wide(shape, dtype,
                                {**sizes, "left_pad": 0, "right_pad": 0},
                                tag)
        for kind in ("fwd", "dq", "dkv"):
            n = pair["flash"][f"launches_{kind}"]
            each = timed[f"{kind}_device_ms"]
            kernels[kind] = {"launches": n, "device_ms": each,
                             "ms": n * each}
        print(f"phase 22 ({part}): kernel E's device time inside the flash "
              f"step (launches x CUDA-graph replay ms at {shape}, every "
              f"token real), "
              + ", ".join(f"{kind} {r['launches']} x {r['device_ms']:.4f} = "
                          f"{r['ms']:.3f} ms" for kind, r in kernels.items())
              + f"; {sum(r['ms'] for r in kernels.values()):.3f} ms of the "
              f"flash step's {pair['flash']['wall'] * 1e3:.1f} ms wall "
              f"[{tag}]", flush=True)
    return {**pair, "timed": timed, "kernels": kernels,
            "wall": time.perf_counter() - t0}


def gemma7b_config(sizes):
    """(d)'s and (f)'s LLMConfig: sizes["gemma7b"] through
    LLMConfig.from_hf_config at gemma_layers layers."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    return dataclasses.replace(LLMConfig.from_hf_config(sizes["gemma7b"]),
                               num_layers=sizes["gemma_layers"])


def run_flash_gemma(tag, device="cuda", sizes=None, build=None):
    """Phase 22 (d): gemma-1 at gemma-7b's published widths (sizes
    ["gemma7b"] through LLMConfig.from_hf_config: 16 heads of 256, one KV
    head each, no softcap, window or query scale, so use_flash takes
    kernel E at head_dim 256) at gemma_layers layers in bf16, its
    causal-LM pair at [1, train_seq] (flash_model_pair; build,
    build_slice by default): the first path through a model that
    launches E at head_dim 256."""
    sizes = sizes or PHASE22
    cfg = gemma7b_config(sizes)
    return flash_model_pair(
        cfg, torch.bfloat16, "d",
        f"gemma-7b ({cfg.hidden_size} wide, {cfg.num_heads} x "
        f"{cfg.head_dim_} heads, {cfg.num_layers} layers)",
        sizes["train_seq"], sizes, tag, device, build or build_slice)


def run_flash_f32(tag, device="cuda", sizes=None, build=None, cfg=None):
    """Phase 22 (e): Llama-3.1-8B (cfg, LLMConfig.llama3_8b() by default)
    at full width and depth in f32, as both packages build the LLM from a
    config with fp16: true (compute_dtype "float16"), its causal-LM pair
    at [1, f32_seq] (flash_model_pair; build, build_slice by default) held
    to f32_loss_gap and f32_grad_rel: the path that launches E's f32
    bodies at head_dim 128 (the forward, dq and dkv, all in split
    TF32)."""
    from llamole_tpu_torch.models.gllm import LLMConfig
    sizes = sizes or PHASE22
    cfg = cfg or LLMConfig.llama3_8b()
    return flash_model_pair(
        cfg, torch.float32, "e",
        f"Llama-3.1-8B in f32 ({cfg.hidden_size} wide, {cfg.num_heads} x "
        f"{cfg.head_dim_} heads, {cfg.num_kv_heads} KV heads, "
        f"{cfg.num_layers} layers)",
        sizes["f32_seq"], f32_gates(sizes), tag, device, build or build_slice)


def f32_gates(sizes):
    """sizes with (e)'s and (f)'s f32 limits as flash_pair's gates."""
    return {**sizes, "loss_gap": sizes["f32_loss_gap"],
            "grad_rel": sizes["f32_grad_rel"]}


def run_flash_f32_gemma(tag, device="cuda", sizes=None, build=None):
    """Phase 22 (f): (d)'s gemma-1 at gemma-7b's published widths and
    gemma_layers layers, built in f32 as both packages build it from a
    config with fp16: true, its causal-LM pair at [1, f32_seq]
    (flash_model_pair; build, build_slice by default) held to
    f32_loss_gap and f32_grad_rel: the path that launches E's f32 bodies
    at head_dim 256."""
    sizes = sizes or PHASE22
    cfg = gemma7b_config(sizes)
    return flash_model_pair(
        cfg, torch.float32, "f",
        f"gemma-7b in f32 ({cfg.hidden_size} wide, {cfg.num_heads} x "
        f"{cfg.head_dim_} heads, {cfg.num_layers} layers)",
        sizes["f32_seq"], f32_gates(sizes), tag, device, build or build_slice)


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_tag()
    print(tag, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from llamole_tpu_torch.ops import cuda_lib
    from llamole_tpu_torch.ops.fused_attention import (
        fused_attention_reference, fused_block_attention)
    from llamole_tpu_torch.ops.attention import masked_attention
    from llamole_tpu_torch.ops.gin_aggregate import (
        gin_aggregate, gin_aggregate_backward,
        gin_aggregate_backward_reference, gin_aggregate_reference)
    from llamole_tpu_torch.ops.graph_attention import graph_attention

    lib = cuda_lib.library()
    print(f"kernels built in {lib.build_seconds:.2f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    a, a32 = check_kernel(fused_block_attention, fused_attention_reference,
                          tag)
    b = check_gin(gin_aggregate, gin_aggregate_reference, tag)
    c = check_gin_backward(gin_aggregate_backward,
                           gin_aggregate_backward_reference, tag)
    d = check_graph_attention(graph_attention, masked_attention, tag)
    kernels = (fused_block_attention, gin_aggregate, gin_aggregate_backward,
               graph_attention)
    t0 = time.perf_counter()
    model, tok = build_slice()
    torch.cuda.synchronize()
    print(f"slice built (random weights on the card) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check_decode_graphs(model.llm, tok, tag)
    timers = PathTimers(model)
    launches, phase7_latency = run_serving(model, tok, timers, kernels, tag)
    molqa = run_eval(model, tok, timers, kernels, tag)
    t0 = time.perf_counter()
    from llamole_tpu_torch.models.gllm import LLMConfig
    cmodel, ctok = build_slice(family_llm(dataclasses.replace(
        LLMConfig.llama3_8b(), num_layers=CONTINUOUS_LAYERS), "cuda"))
    # no latency comparison with phase 7: the depths differ
    continuous = run_continuous(cmodel, ctok, PathTimers(cmodel), kernels,
                                tag)
    del cmodel, ctok
    gc.collect()
    torch.cuda.empty_cache()
    print(f"continuous phase ({CONTINUOUS_LAYERS} of 32 LLM layers): "
          f"{time.perf_counter() - t0:.1f} s wall [{tag}]", flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        train_dir = os.path.join(work, "mmsft")
        b_training, c_training, saved, train_peak, phase9 = run_training(
            model, tok, kernels, tag, train_dir)
        phase22 = run_flash(model, tok, tag)
        gc.collect()
        torch.cuda.empty_cache()
        check_denoiser(model, tag)
        check_graphclip(model, tag)
        check_predictor(model, tag)
        exported = interchange_export(model, work, train_dir, saved, tag)
        t0 = time.perf_counter()
        mesh = run_mesh_training(model, tok, kernels, tag, work, phase9)
        print(f"mesh phase: {time.perf_counter() - t0:.1f} s wall [{tag}]",
              flush=True)
        t0 = time.perf_counter()
        mesh_infer = run_mesh_inference(model, tok, kernels, tag, phase9)
        print(f"mesh inference phase: {time.perf_counter() - t0:.1f} s wall "
              f"[{tag}]", flush=True)
        # phases 11 and 12 start from an empty card: the slice goes first
        del model, tok, timers, saved
        gc.collect()
        torch.cuda.empty_cache()
        print(f"slice freed: {torch.cuda.memory_allocated() / 2**30:.2f} "
              "GiB still allocated", flush=True)
        # phase 22 (d): gemma-7b's ~17 GB of weights on a card of its own;
        # (e): the 8B's ~32 GB in f32 after it; (f): gemma-7b's ~34 GB in
        # f32 after that
        gemma22 = run_flash_gemma(tag)
        gc.collect()
        torch.cuda.empty_cache()
        f32_22 = run_flash_f32(tag)
        gc.collect()
        torch.cuda.empty_cache()
        f32_gemma22 = run_flash_f32_gemma(tag)
        walls22 = {**phase22["walls"], "d": gemma22["wall"],
                   "e": f32_22["wall"], "f": f32_gemma22["wall"]}
        print(f"phase 22: (a) kernel E's checks and times "
              f"{walls22['a']:.1f} s, (b) the training steps with and "
              f"without use_flash {walls22['b']:.1f} s, (c) the flash step "
              f"at [1, {PHASE22['long_seq']}] {walls22['c']:.1f} s, (d) "
              f"gemma-7b's steps and E at their shape {walls22['d']:.1f} s, "
              f"(e) the 8B's f32 steps and E at their shape "
              f"{walls22['e']:.1f} s, (f) gemma-7b's f32 steps and E at "
              f"their shape {walls22['f']:.1f} s; "
              f"{sum(walls22.values()):.1f} s in all "
              f"[{tag}]", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        stack_launches, pretrain_bank = run_stack(kernels, tag)
        t0 = time.perf_counter()
        phase17 = {}

        def entry_points():
            t1 = time.perf_counter()
            phase17.update(run_entry_points(kernels, work, train_dir, tag))
            phase17["wall"] = time.perf_counter() - t1

        inter, merge_rel = run_interchange(kernels, work, train_dir, tag,
                                           then=entry_points)
        print(f"interchange phase (steps 2-6): "
              f"{time.perf_counter() - t0 - phase17['wall']:.1f} s wall, "
              f"then the entry-points phase {phase17['wall']:.1f} s; base "
              f"export {exported['export_s']:.3f} s [{tag}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase21 = {}
    quantized, _ = run_quantized(kernels, tag, phase7=phase7_latency,
                                 phase9_peak=train_peak, phase21=phase21)
    print(f"quantized phase: {time.perf_counter() - t0:.1f} s wall [{tag}]",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase20 = {}
    families = run_families(kernels, tag, phase7=phase7_latency,
                            phase20=phase20, phase21=phase21)
    print(f"families phase: {time.perf_counter() - t0:.1f} s wall [{tag}]",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    finetune = run_finetune(kernels, tag, phase9=phase9, phase20=phase20)
    print(f"finetune phase: {time.perf_counter() - t0:.1f} s wall [{tag}]",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase20["a"] = run_ring(tag)
    print(f"phase 20: (a) ring {phase20['a']['wall']:.1f} s, (b) MoE on the "
          f"mesh {phase20['b']['wall']:.1f} s (inside phase 15 (d)), (c) "
          f"S²-attn under tp {phase20['c']['wall']:.1f} s (inside phase 16 "
          f"(a)); {sum(phase20[k]['wall'] for k in 'abc'):.1f} s in all "
          f"[{tag}]", flush=True)
    quant21 = phase21["a"]
    walls21 = {"a": sum(quant21[k]["wall"] for k in ("molqa", "int4",
                                                      "w8a8", "qlora")),
               "b": phase21["b"]["wall"], "c": phase21["c"]["wall"]}
    print(f"phase 21: (a) {walls21['a']:.1f} s inside phase 14 (int8 "
          f"run_molqa on the mesh {quant21['molqa']['wall']:.1f} s, int4 "
          f"and W8A8 placed {quant21['int4']['wall']:.1f} and "
          f"{quant21['w8a8']['wall']:.1f} s, QLoRA at ZeRO-3 "
          f"{quant21['qlora']['wall']:.1f} s), (b) q / k norms under tp "
          f"{walls21['b']:.1f} s inside phase 15 (a), (c) tied ZeRO-3 "
          f"{walls21['c']:.1f} s inside phase 15 (b); "
          f"{sum(walls21.values()):.1f} s in all [{tag}]", flush=True)
    placements = {
        "A": quant21["molqa"]["A"], "A_mma": quant21["molqa"]["A_mma"],
        "A_fma": quant21["molqa"]["A_fma"],
        "B": quant21["qlora"]["B"] + phase21["c"]["B"],
        "C": quant21["qlora"]["C"] + phase21["c"]["C"]}

    def entry(name, source, replaces, rec, launches, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **{k: rec[k] for k in keys}, **extra}

    flash22 = phase22["train"]["flash"]
    print(f"chip_smoke: the whole script took "
          f"{time.perf_counter() - t_script:.1f} s [{tag}]", flush=True)
    attn_src = "llamole_tpu_torch/csrc/fused_attention.cu"
    gin_src = "llamole_tpu_torch/csrc/gin_aggregate.cu"
    print(json.dumps({"kernels": [
        entry("fused_block_attention", attn_src,
              "llamole_tpu/ops/pallas/fused_attention.py:91", a,
              launches["A"], launches_mma=launches["A_mma"],
              launches_tf32x3=launches["A_tf32x3"],
              launches_fma=launches["A_fma"],
              launches_interchange=inter["A"],
              launches_interchange_mma=inter["A_mma"],
              launches_interchange_tf32x3=inter["A_tf32x3"],
              launches_interchange_fma=inter["A_fma"],
              launches_continuous=continuous["A"],
              launches_continuous_mma=continuous["A_mma"],
              launches_continuous_fma=continuous["A_fma"],
              launches_quantized=quantized["A"],
              launches_quantized_mma=quantized["A_mma"],
              launches_quantized_fma=quantized["A_fma"],
              launches_families=families["A"],
              launches_families_mma=families["A_mma"],
              launches_families_fma=families["A_fma"],
              launches_entry=phase17["A"],
              launches_entry_mma=phase17["A_mma"],
              launches_entry_tf32x3=phase17["A_tf32x3"],
              launches_entry_fma=phase17["A_fma"],
              launches_mesh_inference=mesh_infer["A"],
              launches_mesh_inference_mma=mesh_infer["A_mma"],
              launches_mesh_inference_fma=mesh_infer["A_fma"],
              launches_placements=placements["A"],
              launches_placements_mma=placements["A_mma"],
              launches_placements_fma=placements["A_fma"],
              share=a["share"], sdpa_floor_ms=a["sdpa_floor_ms"],
              sdpa_floor_device_ms=a["sdpa_floor_device_ms"],
              fma_ms=a["fma_ms"],
              fma_device_ms=a["fma_device_ms"]),
        # A's f32 route, the split-TF32 body: the launches of every
        # GraphDiT loaded from a checkpoint (phase 12's serving and phase
        # 17's eval, parity and UI design), its times, bound and share at
        # the main shape in f32, the FMA body's and SDPA's on the same
        # inputs
        entry("A_tf32x3", attn_src,
              "llamole_tpu/ops/pallas/fused_attention.py:91", a32,
              inter["A_tf32x3"] + phase17["A_tf32x3"],
              launches_interchange=inter["A_tf32x3"],
              launches_entry=phase17["A_tf32x3"],
              **{k: a32[k] for k in (
                  "graph_ms", "share", "fma_ms", "fma_device_ms",
                  "fma_max_abs_err", "sdpa_floor_ms", "sdpa_floor_device_ms",
                  "sdpa_allow_tf32")}),
        # B: launches in serving, times at the splice's shape; the
        # training path's launches and times under their own keys
        entry("gin_aggregate", gin_src,
              "llamole_tpu/ops/pallas/gin_aggregate.py:85", b, launches["B"],
              launches_molqa=molqa[1], launches_training=b_training,
              launches_interchange=inter["B"],
              launches_continuous=continuous["B"],
              launches_quantized=quantized["B"],
              launches_families=families["B"],
              launches_finetune=finetune["B"],
              launches_entry=phase17["B"], launches_mesh=mesh["B"],
              launches_mesh_inference=mesh_infer["B"],
              launches_moe_ep=phase20["b"]["B"],
              launches_s2_tp=phase20["c"]["B"],
              launches_placements=placements["B"],
              **{k: v for k, v in b.items() if k.startswith("train_")},
              shape=b["shape"], share=b["share"],
              pretrain_launches=stack_launches["B"],
              **pretrain_bank["gin_aggregate"]),
        # C: launches in run_mmsft, per body too; the pretrainings' under
        # pretrain_*, the large-N bank's times and its pretraining's
        # launches under large_n_*
        # second_body_*: C's second body timed at the staged body's banks
        entry("gin_aggregate_backward", gin_src,
              "llamole_tpu/ops/pallas/gin_aggregate.py:163", c,
              c_training["launches"],
              **{k: v for k, v in c.items() if k.startswith("second_body")},
              launches_quantized=quantized["C"],
              launches_families=families["C"],
              launches_finetune=finetune["C"],
              launches_entry=phase17["C"], launches_mesh=mesh["C"],
              launches_moe_ep=phase20["b"]["C"],
              launches_s2_tp=phase20["c"]["C"],
              launches_placements=placements["C"],
              launches_smem=c_training["launches_smem"],
              launches_global=c_training["launches_global"],
              pretrain_launches=stack_launches["C"],
              **{f"large_n_{k}": v
                 for k, v in stack_launches["large_n"].items()},
              **pretrain_bank["gin_aggregate_backward"]),
        # kernel D is on no path of either package: its launches are
        # those of its check (phase 6), per body; its f32 route (the
        # tf32x3 body) timed under f32_* keys
        entry("graph_attention", attn_src,
              "llamole_tpu/ops/pallas/graph_attention.py:69", d,
              d["launches"][0], launches_mma=d["launches"][1],
              launches_tf32x3=d["launches"][2],
              launches_fma=d["launches"][3],
              launches_from="its check (on no path)",
              library_device_ms=d["library_device_ms"], fma_ms=d["fma_ms"],
              fma_device_ms=d["fma_device_ms"], share=d["share"],
              **{k: v for k, v in d.items() if k.startswith("f32_")}),
        # kernel E: the main keys are one forward + backward at the 8B's
        # attention shape (the three kernels a training layer runs), the
        # halves under fwd_* / bwd_* (per kernel: fwd, dq, dkv), the
        # launches those of phase 22 (b)'s causal-LM flash step (under
        # long_*, (c)'s); train_* (b)'s causal-LM pair, padded_* its
        # GraphLM.loss pair
        entry("flash_attention", "llamole_tpu_torch/csrc/flash_attention.cu",
              "llamole_tpu/models/gllm/model.py:281 (jaxlib "
              "jax/experimental/pallas/ops/tpu/flash_attention.py:758 "
              "_flash_attention_impl, :1121 _flash_attention_bwd_dkv, "
              ":1456 _flash_attention_bwd_dq)", phase22,
              sum(flash22[k] for k in FLASH_COUNTS),
              **{k: flash22[k] for k in FLASH_COUNTS},
              **{f"long_{k}": phase22["long"][k] for k in FLASH_COUNTS},
              **{k: phase22[k] for k in (
                  "share", "device_from", "fwd_ms", "fwd_device_ms",
                  "dq_device_ms", "dkv_device_ms", "bwd_device_ms",
                  "fwd_bound_ms",
                  "fwd_bound_by", "bwd_bound_ms", "bwd_bound_by",
                  "fwd_share", "bwd_share", "plain_fwd_ms",
                  "library_fwd_ms", "bwd_ms", "library_bwd_ms",
                  "library_device_ms", "library_fwd_device_ms",
                  "library_bwd_device_ms", "sdpa_causal_ms",
                  "sdpa_causal_fwd_ms",
                  "f32_max_abs_err", "pairs", "shape", "fwd_body",
                  "bwd_body", "d256", "f32", "f32_d256", "f32_bwd_body")},
              # phase 22 (d): gemma-7b's flash step, E at head_dim 256
              **{f"launches_d256_{k[len('launches_'):]}": gemma22["flash"][k]
                 for k in FLASH_COUNTS},
              d256_step=gemma22["timed"],
              d256_step_kernel_ms=gemma22["kernels"],
              d256_loss_gap=gemma22["loss_gap"],
              d256_grad_rel=gemma22["grad_rel"],
              d256_wall_s={k: gemma22[k]["wall"] for k in ("plain", "flash")},
              d256_peak={k: gemma22[k]["peak"] for k in ("plain", "flash")},
              # phase 22 (e): the 8B's f32 flash step, E's f32 bodies
              **{f"launches_f32_{k[len('launches_'):]}": f32_22["flash"][k]
                 for k in FLASH_COUNTS},
              f32_step=f32_22["timed"],
              f32_step_kernel_ms=f32_22["kernels"],
              f32_loss_gap=f32_22["loss_gap"],
              f32_grad_rel=f32_22["grad_rel"],
              f32_wall_s={k: f32_22[k]["wall"] for k in ("plain", "flash")},
              f32_peak={k: f32_22[k]["peak"] for k in ("plain", "flash")},
              # phase 22 (f): gemma-7b's f32 flash step, E's f32 bodies at
              # head_dim 256
              **{f"launches_f32_d256_{k[len('launches_'):]}":
                 f32_gemma22["flash"][k] for k in FLASH_COUNTS},
              f32_d256_step=f32_gemma22["timed"],
              f32_d256_step_kernel_ms=f32_gemma22["kernels"],
              f32_d256_loss_gap=f32_gemma22["loss_gap"],
              f32_d256_grad_rel=f32_gemma22["grad_rel"],
              f32_d256_wall_s={k: f32_gemma22[k]["wall"]
                               for k in ("plain", "flash")},
              f32_d256_peak={k: f32_gemma22[k]["peak"]
                             for k in ("plain", "flash")},
              train_loss_gap=phase22["train"]["loss_gap"],
              train_grad_rel=phase22["train"]["grad_rel"],
              train_wall_s={k: phase22["train"][k]["wall"]
                            for k in ("plain", "flash")},
              train_peak={k: phase22["train"][k]["peak"]
                          for k in ("plain", "flash")},
              padded_loss_gap=phase22["padded"]["loss_gap"],
              padded_grad_rel=phase22["padded"]["grad_rel"],
              long_wall_s=phase22["long"]["wall"],
              long_peak=phase22["long"]["peak"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
