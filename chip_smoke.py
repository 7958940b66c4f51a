"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero):
  1. environment: card, power limit, versions; builds the CUDA kernels from
     mlx_vlm_tpu_torch/csrc with nvcc (one process per source, in
     parallel) and prints ptxas's registers, static shared memory and
     spills of every kernel (K3, K4, K5's GEMV and its GEMM at both widths,
     K6's kv4_attention_kernel and K7/K8's tq_attention_kernel must not
     spill) and the I2F count of K5's GEMV and GEMM in cuobjdump -sass
     (must be 0), and whether PIL imports (the server part's image goes
     over HTTP as a PNG data URI only where it does);
  2. each kernel (K1 int4_matmul, K2 int4_matvec, K3 fused_decode, K4
     flash_attention, K5 qmatmul_int4 / qmatmul_int8, K6
     int4_kv_attention, K7 tq_kv_attention, K8 tq_kv_attention_split)
     against its plain PyTorch version on the card at Qwen2-VL-7B shapes
     (K1 also at groups of 32 and 128, on a ragged 100-row chunk that
     splits K and at M = 20 through every 7B linear and the lm_head (the
     batched speculative verify); K2 at M = 1, 2, 4 and 8, groups of 32
     and 128 and a ragged n = 1000, on a 4-row lm_head (a 4-slot batch
     step), at M = 5 through every 7B linear and the lm_head (the
     single-stream speculative verify) and at M = 1 through Qwen2-VL-2B's
     linears and lm_head (a drafter step), timed also
     with its weights cold in L2 (`graph_ms` over copies of the weight),
     and its
     kernels per call counted; K5's GEMV at M = 1, 2, 4 and 8, groups of
     32 and 128 and a ragged N = 1000 (timed cold and warm), its GEMM at
     both widths at M = 512, on a ragged chunk (M = 100, N = 1000) and a
     narrow one at g = 32, and at 8 bits on request (h)'s 58-row chunk at
     the four linear shapes (timed cold and warm), and at 8 bits and g =
     128 with an odd number of groups a row (Qwen2-VL-72B's down_proj, K
     = 29568, on the GEMV in chunks and on the GEMM; K = 3712 on a one-
     chunk and a persistent GEMV; N even and odd), and at 4 bits through
     Qwen3-VL-8B's linears at M = 1 and 512 and its lm_head (N = 151936)
     at M = 1, timed cold and warm, and through Qwen3-VL-30B-A3B's
     experts (4 bits: gate / up K = 2048 N = 768, down K = 768 N = 2048)
     at M = 1, 8 and 32 and its 8-bit router (N = 128) at M = 1 and 512,
     and the 8-bit GEMM's trailing half stage at g = 32 (K = 3616 and 96,
     odd multiples of 32), and at 4 bits through Llama-3.1-8B's gate / up
     (N = 14336), down (K = 14336) and lm_head (N = 128256) and
     LLaVA-1.5-7B's gate / up (N = 11008), down (K = 11008) and lm_head
     (N = 32064) at M = 1 and 512, and Llama-3.1-8B's q / o, k / v,
     gate / up, down and lm_head at the drafters' verify rows (M = 5, 9
     and 16) and its lm_head at DFlash's 15 draft rows, and at the text
     MoE families' exact
     mode: the 8-bit routers of Mixtral (N = 8, K = 4096), Phi-3.5-MoE
     (16, 4096), Granite 3.0 (40, 1536), Qwen1.5-MoE (60, 2048) and OLMoE
     (64, 2048) and Qwen1.5-MoE's shared-expert gate (N = 1, K = 2048, 8
     and 4 bits) at M = 1 and 512, Qwen3-30B-A3B's q / k / v / o at M = 1
     and 512 and its and Mixtral's heads (N = 151936, 32000) at M = 1,
     timed cold and warm, and at 4 bits through PaliGemma2-3B's q (K =
     2304, 36 groups; N = 2048), k / v (N = 1024), o (K = 2048), gate / up
     (N = 9216), down (K = 9216) and tied head (N = 257216) at M = 1 and
     512 and PaliGemma-3B's k / v (N = 256) at M = 1 and 512 and head (K =
     2048) at M = 1 (`K5_PALIGEMMA_CASES`), every case with its
     plan, kernels per call and a bit-identical repeat; K5's
     expert-indexed entry (`qmatmul_experts`) at those expert stacks (128
     experts) for 8, 32 and 40 (token, expert) pairs with two pairs on
     expert 127, and at the text MoE families' stacks (gate / up [E, I,
     D] and down [E, D, I], `EXPERT_STACKS`): Mixtral [8, 14336, 4096] at
     2 and 8 pairs, OLMoE [64, 1024, 2048] at 8, Qwen1.5-MoE [60, 1408,
     2048] at 4 (at g = 64 and 128, where its down projection has an odd
     number of groups a row), Phi-3.5-MoE [16, 6400, 4096] at 2 and
     Granite 3.0 [40, 512, 1536] at 8, each with two pairs on the last
     expert, timed cold (copies of the stack) and warm, with kernels
     per call (1), a repeat and bytes per second; the route rules at the
     shapes their kernels refused (K4 at head size 64 takes `sdpa`, K5 at
     group 16 the dequantize route, the w4grp fold at group 24
     per-channel int8), each held to its plain version;
     K4 at the 8k rows (offset 7680; left_pad 100; window 1024), at (c)'s
     first, middle and last chunk (S = 512 against C = 8704 at offsets 0,
     4096, 8192), at two batch rows with their own offsets and
     left_pads, at 12 heads over 2 KV heads (the 2B drafter's last
     chunk of (c)'s prompt) and at 32 over 8 (Qwen3-VL-8B's last chunk of
     (q2)'s prompt), each timed cold (`graph_ms` over copies of k/v) and warm,
     with its kernels per call and a bit-identical repeat;
     K3: 4 decoder layers and the int4 head at offsets 1, 300 and 8545
     with 1e3 past the cursor and at 8545 with NaN past it (the cursor a
     device word, the K/V tensor maps over the whole capacity), and all
     28 layers and the head at the 2B drafter's widths (hidden 1536, 12 / 2
     heads, intermediate 8960, vocab 152064) at offsets 300 and 8545, each
     with its kernels per call, a bit-identical repeat and its bytes per
     second beside the bound's; then one K3 launch captured in a CUDA graph and
     replayed with its cursor word rewritten between replays (300, then
     8545), each replay bit-identical to an eager call at that cursor;
     K6-K8: 4 KV heads of 7 query rows over an 8704-slot cache at offsets
     1, 300 and 8545, left_pad 100 and per-row cursors, K6 also with NaN
     scales past the cursor (bit-identical to 1e3 there) and at
     PaliGemma-3B's decode step (one KV head of 8 query rows at head dim
     256, the same capacity: offsets 1, 300 and 8545, left_pad 100, NaN
     past the cursor; `check_k6_paligemma`), K8 also at
     kv_bits 3.05 and 3.95 (8-dim segments); each timed cold (`graph_ms`
     over copies of the codes, scales and query) and warm, with its plan,
     kernels per call (must be 1), a bit-identical repeat and its bytes
     per second beside the bound's), each with its device time, the
     least
     time the card could take (`bound_ms`, from bytes at 3.35 TB/s or
     operations at 989 TFLOP/s) and, where one exists, the time of one
     PyTorch call computing the same function (`library_ms`: K4 against
     scaled_dot_product_attention; K1, K2 and 4-bit K5 against
     torch._weight_int4pack_mm after an untimed repack);
  3. the slice on the card (bf16, kernels) against the slice on the CPU
     (plain versions) at 7B widths with 2 decoder layers (the first two of
     phase 4's checkpoint, which `family_checkpoints` builds here),
     teacher-forced:
     decode through K3 on the bf16 cache (CPU in f32, 4 steps), and through
     K6, K7 and K8 with kv_bits 4, 3.5 and 3.5 split (CPU in bf16, 4
     steps); then the runtime quantization modes (2 steps each): exact
     4-bit (K5) and w8chan 8-bit against f32 CPU runs, exact 8-bit (K5)
     with the 8-bit group-affine KV cache against a bf16 CPU run; for each
     of those caches (and the bf16 cache on the per-linear route, and a
     seeded sampled request) the graph-replayed block decode on the card
     against the same request decoded with eager steps on the card:
     tokens and logprobs bit-identical; then a 3-slot BatchGenerator (a
     text prompt and the image prompt admitted together with 3 tokens
     each, a text prompt with 2 admitted after the first cycle, blocks of
     1 step, prefill chunks of 128 rows) with
     the bf16 cache and with kv_bits 4 (K6 on per-row cursors): its
     logits on the card, teacher-forced with the CPU's greedy tokens, held
     to the CPU's (f32 and bf16) request by request, over its admission
     and each decode step, by the parity rule, with K1 / K2 / K6 launches
     held to the chunks and steps that ran; and the generator's
     graph-replayed steps (one capture across both admissions) against
     its eager steps on the card, tokens and logprobs bit-identical; and
     speculative decoding against a 2-layer drafter at the 2B's widths:
     the single-stream rounds (greedy and sampled) and the batched rounds
     (three requests, one admitted late), each round after the first a
     replay of the round captured once, against every round eager: tokens,
     logprobs and both models' caches bit-identical; then the new
     families against the CPU, teacher-forced, each in its own
     prefill layout with its own processor: Qwen2.5-VL at 7B widths (2
     decoder layers, the whole 32-block windowed tower; w4grp, K1 and K2
     on the prefill, K3 every step, 8 steps; against a bf16 CPU run, see
     FAMILY_CASES) and Qwen3-VL at 8B widths (f32 CPU runs)
     (3 decoder layers, so that all 3 deepstack levels are added; the
     whole 27-block tower) in its default w8chan mode and in exact (K5),
     2 steps each, and Qwen3-VL-MoE at 30B-A3B widths (2 decoder layers of
     128 experts, top-8, the whole tower; its routers at 8 bits) in its
     default mode (w8chan linears, the experts on K5) and in exact, 2
     steps each, launches held to what ran (the experts by `moe_want`),
     and each model's replayed decode against eager steps; and
     Llama-3.1-8B (2 decoder layers, text only; exact, K5) and LLaVA-1.5-7B
     (2 decoder layers, the whole 24-block CLIP tower, a 336x336 image; its
     default w8chan mode and exact) at their published widths, 2 steps
     each against f32 CPU runs, launches held to what ran,
     and each model's replayed decode against eager steps; and the text
     MoE decoders at their published widths, text only, random 4-bit
     weights with 8-bit routers, 2 teacher-forced steps each against f32
     CPU runs (bf16 for Qwen3-30B-A3B, see FAMILY_CASES): Qwen3-30B-A3B
     (2 of its layers; default and exact),
     Qwen1.5-MoE-A2.7B (1; its shared expert), Mixtral-8x7B (1),
     OLMoE-1B-7B (2), Phi-3.5-MoE (1) and Granite-3.0-3B-A800M (2), the
     experts by `moe_want`, each model's replayed decode against eager
     steps; and PaliGemma2-3B and PaliGemma-3B at their published widths
     (2 decoder layers, the whole 27-block SigLIP tower, a 224x224 image)
     in their default w8chan mode and in exact (K5 on every linear and the
     tied head), and their text models as text-only Gemma-2-2B (exact) and
     Gemma-2B (w8chan) checkpoints on the same arrays, against f32 CPU
     runs (2 steps; PaliGemma2's exact 4), each model's replayed decode
     against eager steps; and video
     (`video_parity`, 4 steps against the CPU by the parity rule,
     launches held to what ran): a 4-frame 112x112 clip, and a 224x224
     image before it, on the Qwen2-VL slice (f32 reference), the clip on
     Qwen2.5-VL (bf16 reference) and on Qwen3-VL (128x128 frames at its
     patch 16, timestamped; f32 reference); and the target-coupled
     drafters (`phase_drafter_parity`) at Llama-3.1-8B's widths on its
     checkpoint cut to 3 layers, exact (K5) against f32 CPU runs: EAGLE-3
     (capturing layers 0, 1, 2), MTP, DFlash (2 of its layers, block 16)
     and DDTree (budget 8), each drafter drawn on the card: 16 greedy
     tokens with their verify rows held by the parity rule to the CPU's
     logits teacher-forced with them, every round after the first a
     replay of the captured one, bit-identical (tokens and both caches)
     to every round eager, the drafter's first-round logits (DDTree: the
     [bonus | tree] forward) against the CPU's teacher-forced with the
     card's tokens, and the all-accepted case (final norms zeroed).
     Before the phase, `check_fold_on_card` folds Llama-3.1-8B's embedding
     table (128256 x 4096) to per-channel int8 on the host and on the card,
     bytes equal, both times printed; every fold of phases 3-4 runs on the
     card (`fold_once`).  The phase prints the seconds of each of its
     parts;
  4. the main path at full Qwen2-VL-7B width (random mlx-format weights,
     28 decoder layers, 32 vision blocks): eight greedy requests through
     load_model_from_weights and stream_generate, each with the kernels'
     launch counters set to 0 just before it and read just after.  Each
     request decodes in blocks of 32 steps: the first step eager, then one
     captured CUDA graph replayed per token under sync debug mode "error",
     one host fetch per block and one for the first token (checked); it
     prints its first-step and capture seconds, replays, fetches, ms per
     token and ms per replayed token (first step and capture taken out),
     and each kernel's launches are held to the decode steps that ran;
     after it, its captured step is replayed alone between CUDA events
     (device ms per step beside the ms per replayed token) and, with
     --profile, under torch.profiler (the step's kernels by device time).
     Requests (a)-(f) run 4-bit weights in the default w4grp layout: (a)
     (100 tokens) and (c) decode through K3; (b) (100 tokens) runs with
     MLX_VLM_TPU_FUSED_DECODE=0, the per-linear route (K2); (d), (e) and
     (f) take (c)'s image and ~8.2k-token prompt with kv_bits 3.5 (K7),
     3.5 and MLX_VLM_TPU_TQ_SCHEME=split (K8) and 4 (K6); (w1) a 64-frame
     448x448 clip (32,768 patches, the tower per frame group) and a short
     prompt, ~8.2k tokens, 16 tokens: K1 and K4 on every layer of every
     prefill chunk, K3 every step; each video request (run_video) also
     prints the host seconds of its preprocessing and of the vision
     cache's key and the prefix cache's salt, and the tower's device
     ms.  Then one 28-layer K3 step and its plain version are timed on the loaded model
     (beside the times of the design that took its offset from the host).
     Requests (g) and (h) each load their own model with
     MLX_VLM_TPU_RUNTIME_QUANT=exact, so every linear and the lm_head run
     K5: (g) (a)'s 4-bit checkpoint, image and prompt; (h) an 8-bit
     checkpoint, text only, kv_bits 8 with MLX_VLM_TPU_KV_SCHEME=affine.
     Before those, on (a)-(f)'s model, continuous batching: (i)
     batch_generate of five prompts (three text prompts of different
     lengths and two images) into 4 slots, 32 tokens each, blocks of 8,
     greedy, bf16 batch cache, its texts naming every token, and (j) the
     same requests through BatchGenerator(kv_bits=4) (K6 on per-row
     cursors): each prints its tokens and aggregate tokens/s, its ms per
     replayed batch step, its capture (must be one per generator),
     replays, fetches (blocks + admissions) and launches, held to what ran
     (K2 = 197 per batch step + one head per prefill chunk holding a
     row's last token, K1 = 196 per prefill chunk, K6 = 28 per step in
     (j), K3 = 0); (j) also replays its captured step alone between CUDA
     events (and profiles it with --profile).  (i)'s requests then run
     again with eager steps, their texts equal to (i)'s, and each row's
     logits are held by the parity rule, at every step, to its prompt
     run alone on the per-linear route (a B = 1 cache, K2 at M = 1)
     teacher-forced with the row's tokens; with --profile, three of
     those eager batch steps are traced too.  Then the server part, on
     the same model and the byte tokenizer: create_server (4 slots of 4096
     rows, blocks of 8) served from a thread, /health, /v1/models and
     /metrics checked, then six requests sent at once from client threads:
     (k1) a chat with logprobs, (k2) a streamed chat, (k3) a 448x448 image
     chat (a PNG data URI, or through the engine where PIL is missing),
     (k4) /v1/messages, (k5) a fifth chat that waits for a slot, each 32
     tokens, and (k6) a json_schema chat (24 tokens, every step an eager
     K3 launch with the automaton picking on the host); then a second
     server with kv_bits=4 and two 16-token chats at once.  Every answer
     200 and well formed (SSE ends in [DONE]), usage counting its tokens,
     its text its tokens' text, (k6)'s content a JSON object satisfying
     the schema; one capture per generator; launches held to what ran (K1
     196 a prefill chunk, K2 197 a batch step + one head per chunk holding
     a prompt's last token, K3 = (k6)'s decode steps, K6 28 a step in the
     second server, 0 in the first; (k6)'s decode steps one for each of
     its recorded picks after the first); each request's ttft_s and
     generation_tps from /metrics, the aggregate tokens/s and the part's
     seconds printed; both servers shut down, then each answer's logits
     (kept on the card by a recording sampler inside the captured step)
     held at every step by the parity rule to its prompt run alone on the
     single stream, teacher-forced with its tokens (bf16 rows on the
     per-linear route, (k6) on K3, the kv_bits=4 rows with their prompts
     prefilled in their admission's own padded layout and copied into a
     one-row 4-bit cache, so that none of the generator's code runs; the
     same prompts prefilled in one unpadded chunk are printed beside,
     with the share of 4-bit codes that the layout flips).  Then the
     prefix-caching part (apc.py), greedy, 16 tokens a request: (l1) (c)'s
     image and prompt through stream_generate(apc=APCManager(),
     vision_cache=...) (every 16-token block of the prompt stored, no
     hit; the harvest's seconds and bytes), (l2) a second turn (the
     prompt, (l1)'s reply and ~400 new tokens): the hit the longest shared
     multiple of 16, the restored rows byte-equal to (l1)'s, K1 and K4
     launched for the suffix's chunks only (K4 at the restored offset), K3
     every decode step, the vision tower not run again; (l2c) the same
     prompt cold without APC in a cache of (l2)'s capacity, teacher-forced
     with (l2)'s tokens, its logits holding (l2)'s by the parity rule, the
     two TTFTs printed; (l3) / (l4) exact mode at kv_bits=4: (a)'s image
     with ~2k tokens of text, then the same prompt with a 64-token
     follow-up: one hit, the restored snapshot byte-equal to (l3)'s cache
     in every buffer with its cursor at (l3)'s length, K6 28 a step; (l4)
     held to its prompt prefilled in its own layout without APC and to
     (l4c), its prompt cold in a cache of the snapshot's capacity (the
     4-bit codes that differ in the shared and the suffix rows printed);
     (m) a server with APC: two chats sharing a ~1,500-token system
     prompt, one after the other: /v1/cache/stats 2 lookups and one hit,
     the second chat's K1 launches its suffix's chunks only, one capture,
     its logits held to its prompt alone on the single stream, and
     /v1/cache/reset empties the pool.  Then the speculative part
     (speculative/), k = 4, against a drafter at Qwen2-VL-2B's widths (14
     of its 28 layers) with the 7B's vocabulary (random mlx 4-bit weights,
     built and folded once):
     (s1) (a)'s image and prompt, greedy, 64 tokens; (s2) the target as its
     own drafter, 32 tokens; (s3) (c)'s image and ~8.2k-token prompt, 16
     tokens (K4 on both models); (s4) temperature 0.7 with a seed; each
     request's launches held to its rounds and chunks, one capture and a
     replay a round after the first, its rounds, drafted and accepted
     tokens, and a round's device ms (draft and verify each captured
     alone) beside its host ms; the greedy ones' verify logits (recorded
     on the card inside the captured round) held by the parity rule to
     their prompt alone, prefilled in the request's own layout, through
     plain greedy decoding on the per-linear route (K2 at M = 1, the
     verify's layers), teacher-forced (the unpadded prompt's distances on
     that route and on the fused route, K3, printed beside);
     one plain decode step's device ms beside a round's, and the per-draft
     acceptance at which a round pays for itself; (s5) a server with the
     drafter answering four chats at once (two greedy, two at 0.7): every
     answer well formed with "speculative" in its /metrics envelope, one
     round capture, launches held to the rounds and chunks, the greedy
     answers held by the parity rule to their prompts alone, prefilled in
     their admission's layout and decoded in their verify's (K1 at M =
     20; the per-linear route at M = 1 printed beside).  Each
     single-stream round's k drafter steps and its sync are one K3
     launch each (the drafter's fused route, with the head inside).
     Then Qwen2.5-VL-7B (the Qwen2-VL-7B checkpoint's language model and
     its own 32-block windowed tower), default w4grp: (n1) a 448x448
     image request of 100 tokens (K1 on the prefill, K3 every decode
     step), (w2) a 448x448 image and a 16-frame 448x448 clip, 32 tokens,
     (n2) `batch_generate` of (i)'s prompts, (n3) one image chat
     through the server; and Qwen3-VL-8B (36 layers, the 27-block
     deepstack tower) loaded exact: (q1) an image request, (q2) an image
     and a ~8.5k-token prompt (K4 on every layer of every chunk), (w3) a
     16-frame 448x448 clip with its timestamps, 32 tokens, (q3)
     `batch_generate` of a text and an image prompt admitted together
     (rows of embedding widths D and 4D); and Qwen3-VL-30B-A3B (6 of
     its 48 layers of 128 experts, top-8, the 27-block tower, random 4-bit
     weights with 8-bit routers) in its default mode: (u1) an image request of 64
     tokens, (u2) (i)'s prompts through `batch_generate`, (u3) an image
     chat through the server, (u4) an image and a ~8.5k-token prompt (K4);
     and Llama-3.1-8B (32 layers, its llama3 rope scaling, text only)
     loaded exact: (t1) a short chat of 32 tokens, then the same prompt
     with kv_bits=4, 16 tokens (K6 on every layer and step), (t2) a
     ~8.3k-token prompt, 16 tokens (K4 on every layer of every chunk),
     (t3) `batch_generate` of (i)'s texts, then (z) the drafter kinds
     on the same model (`run_drafters`: full-width drafters written as
     checkpoints without the embedding and head and loaded onto the card
     by `load_drafter`; 32 greedy tokens each of EAGLE-3 and MTP (k = 4,
     a 5-row verify), DFlash with adaptive and with fixed blocks of 16,
     and DDTree with 8 nodes; K5 launches held to the rounds, every token
     the argmax of its own verify row, the stream held by the parity rule
     to the plain logits teacher-forced with it, a round's device ms
     beside the plain step's and host ms per round); and LLaVA-1.5-7B (32 decoder
     layers, the 24-block CLIP tower) loaded exact: (v1) a 336x336 image
     and a short prompt, 32 tokens, (v2) an image chat through the server;
     and Qwen3-30B-A3B (QWEN3_MOE_LAYERS of its 48 layers of 128 experts,
     top-8, text only; Qwen3-VL-30B-A3B's requests take its first 6
     layers) in its default mode: (x1) a short chat of 64 tokens, (x2) a
     ~8.3k-token prompt, 16 tokens (K4 and the prefill route on every
     layer of every chunk), (x3) `batch_generate` of (i)'s texts in 4
     slots, (x4) a chat through the server, (x5) (x1)'s prompt at
     kv_bits=4, 16 tokens (K6 on every layer and step); and Mixtral-8x7B
     (MIXTRAL_LAYERS of its 32 layers): (y1) a short chat of 32 tokens in
     the default mode and in exact; and PaliGemma2-3B (26 decoder layers,
     the 27-block SigLIP tower): (p1) a 224x224 image and a short prompt,
     32 tokens, in the default w8chan mode (no kernel) and exact (K5, no
     K4: the prefix keeps `flash_ok` False), (p2) exact, an image and a
     ~8.5k-token prompt, 16 tokens (the chunked bidirectional prefill, the
     4096 window on 13 of the 26 layers at decode), and PaliGemma-3B
     (18 decoder layers) exact: (p3) an image and a
     short prompt at kv_bits=4, 16 tokens (K6 once a layer and step);
     each with its load seconds, TTFT, ms per replayed token, the
     replayed step's device ms and peak GiB,
     its launches held to what ran (the expert layers: one
     expert-indexed launch a projection at decode, K5 per expert with
     rows in long prefill chunks; the exact models K5 on every linear and
     head); each of the later models' parts prints its seconds.
Phases 3 and 4 fold each mlx triple once for all of its loads in one
runtime mode (`fold_once`), across the checkpoints that share it.
Each phase prints its seconds.  The line before the last is the kernel
report, the last line the result.  Needs no network and imports nothing of
JAX.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _events_ms(run, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int = 20) -> float:
    """Mean time of an eager fn() call in ms from CUDA events around a loop:
    includes the host's launch overhead whenever the host is the slower."""
    for _ in range(3):
        fn()
    return _events_ms(fn, iters)


def graph_ms(calls: list, iters: int = 20) -> float:
    """Mean device time in ms of one of `calls`: they are captured in turn
    into one CUDA graph and the graph is replayed between CUDA events, so no
    host work is timed.  Calls on copies of a weight that together hold
    COLD_BYTES or more (cold_copies) find it cold in L2, as a decode step
    does."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            for fn in calls:
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    ms = _events_ms(graph.replay, iters) / len(calls)
    del graph
    return ms


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms, fn replayed back to back: a weight
    that fits in the 50 MB L2 is read from L2 after the first replay."""
    return graph_ms([fn], iters)


# Bytes of weight copies that the other calls of a cold timing read between
# two reads of one copy: twice the H100's 50 MB L2.
COLD_BYTES = 100e6


# the most copies a cold timing captures: weights under COLD_BYTES /
# MAX_COLD_COPIES (about 100 KB; the text MoE families' routers) are timed
# warm only
MAX_COLD_COPIES = 1024


def cold_copies(nbytes: float) -> int:
    """Copies of a weight of `nbytes` for a cold timing: the other copies
    together hold COLD_BYTES or more."""
    return math.ceil(COLD_BYTES / nbytes) + 1


def kernels_per_call(fn) -> int:
    """Kernels that one fn() call puts on the device: the kernel, memcpy
    and memset nodes of a CUDA graph capturing it, read with the driver's
    cuGraphGetNodes / cuGraphNodeGetType."""
    import ctypes

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        fail("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    del graph
    # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY and _MEMSET are 0, 1 and 2
    return sum(k in (0, 1, 2) for k in kinds)


# ------------------------------------------------------------ phase 1


def phase_environment() -> None:
    import torch

    from mlx_vlm_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"driver {driver} nvcc: {nvcc} python {sys.version.split()[0]}")
    # the server part sends its image as a PNG data URI only where the
    # server can decode it (openai._decode_image needs PIL)
    pil = importlib.util.find_spec("PIL") is not None
    print(f"PIL importable: {pil}", flush=True)
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    print(f"kernels built and loaded in {build_s:.2f} s "
          f"({_cuda.library_path().name})", flush=True)
    for source, log in _cuda.BUILD_LOG.items():
        for name, regs, spills in ptxas_report(log):
            print(f"  ptxas {source} {name}: {regs}; {spills}", flush=True)
            # K5's GEMV and GEMM (both widths), K4, K3, K6, K7 and K8 keep
            # their operands and accumulators in registers
            if name.startswith(("qmv_kernel", "qmm_gemm_kernel",
                                "flash_fwd_kernel", "fused_decode_kernel",
                                "kv4_attention_kernel",
                                "tq_attention_kernel")) and (
                    "0 bytes spill stores, 0 bytes spill loads" not in spills):
                fail(f"ptxas spills in {name}: {spills}")
    # K5's GEMV and GEMM take their codes exact with no integer-to-float
    # conversion
    for name, n in sass_conversions(_cuda.library_path()).items():
        if "qmv_kernel" in name or "qmm_gemm_kernel" in name:
            print(f"  sass {name}: {n} I2F / I2FP", flush=True)
            if n:
                fail(f"{name} converts integers to floats ({n} I2F)")


def sass_conversions(library) -> dict:
    """Integer-to-float conversions (I2F, I2FP) per kernel, by mangled name,
    in the SASS of the built library as cuobjdump -sass prints it."""
    import re

    from mlx_vlm_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\sI2F", line):
            counts[name] += 1
    return counts


def ptxas_report(log: str) -> list:
    """(kernel, registers and static shared memory, spills) for each entry
    function in nvcc -Xptxas -v output; names demangled by c++filt where the
    host has it."""
    import re
    import shutil

    rows, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill" in line and name:
            spills = line.strip()
        elif "Used" in line and name:
            rows.append([name, line.split(":", 1)[1].strip(), spills])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.split("\n")
        for r, full in zip(rows, names):
            r[0] = full.replace("(anonymous namespace)::", "").split("(")[0]
            r[0] = r[0].removeprefix("void ")
    return [tuple(r) for r in rows]


# ------------------------------------------------------------ phase 2

K1_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
K2_SHAPES = K1_SHAPES + ((3584, 152064),)
# K1's further cases (M, K, N, group size): mlx's other group sizes, and a
# ragged row count on the narrow shape, which takes the split-K pass
K1_EXTRA = ((512, 3584, 3584, 32), (512, 3584, 3584, 128), (100, 3584, 512, 64))
# and the batched speculative verify's shapes: [4 rows, k + 1 = 5] tokens,
# so M = 20, through every 7B linear and the lm_head
K1_EXTRA += tuple((20, K, N, 64) for K, N in K2_SHAPES)
K1_TOL = 1e-2
# Qwen2-VL-2B's linears and lm_head (at the 7B's vocabulary, as phase 4's
# drafter has it): hidden 1536, k/v 2 x 128, intermediate 8960
K2_2B_SHAPES = ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),
                (1536, 152064))


def random_int4(K: int, N: int, gen, device, g: int = 64) -> "object":
    """Random halves-packed int4 weight of group size g whose dequantized
    values have std ~0.02 (codes uniform in [0, 16), zero-centred by the
    bias)."""
    import torch

    from mlx_vlm_tpu_torch.core.quant import Int4GroupedTensor, _int4_half_width

    n2p = _int4_half_width(N)
    G = K // g
    qp = torch.randint(0, 256, (K, n2p), generator=gen, dtype=torch.uint8,
                       device="cpu").to(device)
    planes = []
    for _ in range(2):
        s = (0.02 / 4.6) * (0.5 + torch.rand((G, 1, n2p), generator=gen))
        planes += [s, -7.5 * s]
    sl, bl, sh, bh = (p.to(device) for p in planes)
    return Int4GroupedTensor(qp=qp, sl=sl, sh=sh, bl=bl, bh=bh, n=N,
                             group_size=g, out_dtype="bfloat16")


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM bytes/s
# and bf16 tensor-core operations/s, at the 700 W power limit.
HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12


def bound(nbytes: float, nops: float) -> tuple:
    """(least ms the card could take, what bounds it): each input byte read
    once and each output byte written once at the HBM rate, against the
    operations at the bf16 peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / BF16_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def _check(results: list, name: str, shape: str, out, ref, rel_tol: float,
           kernel, plain, floor: float = 1.0, work=(0.0, 0.0),
           library=None) -> None:
    """Record max|out - ref| against rel_tol * max(floor, max|ref|) and time
    the kernel, its plain version and the library call computing the same
    function (if any; its own max|lib - ref| is printed beside it): device
    time (graph replay) and eager call time.  `work` is (bytes, operations)
    of the call, for its bound."""
    import torch

    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = rel_tol * max(floor, float(ref.float().abs().max()))
    ok = err <= tol
    ms, plain_ms = device_ms(kernel), device_ms(plain, iters=5)
    lib_ms, lib = None, ""
    if library is not None:
        lib_err = float((library().float() - ref.float()).abs().max())
        lib_ms = device_ms(library)
        lib = f" library_ms={lib_ms:.4f} (library max_abs_err={lib_err:.3e})"
    call = call_ms(kernel)
    bound_ms, bound_by = bound(*work)
    print(f"  {name} {shape}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}{lib} (device time) "
          f"bound_ms={bound_ms:.5f} ({bound_by}) "
          f"kernel_call_ms={call:.4f} (eager, host included) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    results.append({"name": name, "shape": shape, "err": err, "tol": tol,
                    "ms": ms, "plain_ms": plain_ms, "call_ms": call,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "ok": ok})


def int4_work(M: int, t, out_bytes: int) -> tuple:
    """(bytes, operations) of x [M, K] bf16 @ dequant(t): the codes and the
    four f32 scale planes read once, the output written once."""
    K = t.qp.shape[0]
    nbytes = M * K * 2 + t.qp.numel() + 4 * t.sl.numel() * 4
    return nbytes + M * t.n * out_bytes, 2.0 * M * K * t.n


def int4pack_mm(codes, s, b, g: int, x):
    """The library yardstick for a group-affine int4 product: a closure
    making one torch._weight_int4pack_mm call that computes x @ w.T for
    w[n, k] = codes[n, k] * s[n, k // g] + b[n, k // g] (codes uint8 [N, K]
    on the card; s, b [N, K / g]), or None where this torch build refuses
    the op or the shape (printed).  The repack runs once, untimed: the op
    keeps two codes per byte with the even k in the high nibble and
    dequantizes (code - 8) * scale + zero, so zero = b + 8 s, both rounded
    to bf16.  The port never calls it."""
    import torch

    try:
        packed = ((codes[:, 0::2] << 4) | codes[:, 1::2]).contiguous()
        w = torch._convert_weight_to_int4pack(packed, 8)
        s, b = s.float(), b.float()
        sz = torch.stack([s.T, (b + 8 * s).T], dim=-1).to(
            torch.bfloat16).contiguous()
        torch._weight_int4pack_mm(x, w, g, sz)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"  torch._weight_int4pack_mm refused x {tuple(x.shape)} "
              f"w {tuple(codes.shape)} g={g}: {str(exc).splitlines()[0]}",
              flush=True)
        return None

    def call():
        return torch._weight_int4pack_mm(x, w, g, sz)

    call.args = (x, w, g, sz)  # for cold copies (int4pack_copies)
    return call


def int4pack_copies(call, copies: int) -> list:
    """`call` and copies - 1 calls like it, each on its own copy of the
    repacked weight."""
    import functools

    import torch

    x, w, g, sz = call.args
    return [call] + [functools.partial(torch._weight_int4pack_mm, x,
                                       w.clone(), g, sz.clone())
                     for _ in range(copies - 1)]


def grouped_int4pack_mm(t, x):
    """int4pack_mm for a halves-packed Int4GroupedTensor (K1, K2): column n
    sits in the low nibbles of qp[:, n] for n < N2p, in the high nibbles of
    qp[:, n - N2p] after that."""
    import torch

    codes = torch.cat([t.qp & 0xF, t.qp >> 4], dim=1)[:, :t.n].T
    s = torch.cat([t.sl, t.sh], dim=-1)[:, 0, :t.n].T
    b = torch.cat([t.bl, t.bh], dim=-1)[:, 0, :t.n].T
    return int4pack_mm(codes, s, b, t.group_size, x)


# K2 cases (M, K, N, group size): the five K2_SHAPES at M = 1 (a decode
# step's linears and the lm_head), M = 2, 4 and 8 at 3584^2 and at
# N = 18944 (batched decode), mlx's other group sizes, and a ragged n = 1000
# (N2p = 512)
K2_CASES = (tuple((1, K, N, 64) for K, N in K2_SHAPES)
            + tuple((M, K, N, 64) for M in (2, 4, 8)
                    for K, N in ((3584, 3584), (3584, 18944)))
            + tuple((1, 3584, 3584, g) for g in (32, 128))
            + ((1, 3584, 1000, 64),)
            # the lm_head of a 4-slot batch decode step (phase 4 (i), (j))
            + ((4, 3584, 152064, 64),)
            # the single-stream speculative verify: k + 1 = 5 rows through
            # every 7B linear and the lm_head
            + tuple((5, K, N, 64) for K, N in K2_SHAPES)
            # a 2B drafter's step: one row through its linears and head
            + tuple((1, K, N, 64) for K, N in K2_2B_SHAPES))
K2_TOL = 1e-3


def half_ulp_bf16(v):
    """Half a bf16 ulp of |v|, elementwise: 2^(e - 9) for |v| = m 2^e with
    m in [0.5, 1), and 0 where v is 0."""
    import torch

    _, e = torch.frexp(v.abs())
    return torch.ldexp((v != 0).to(v.dtype), e - 9)


def clone_int4(t):
    """A copy of an Int4GroupedTensor in fresh device memory."""
    return type(t)(qp=t.qp.clone(), sl=t.sl.clone(), sh=t.sh.clone(),
                   bl=t.bl.clone(), bh=t.bh.clone(), n=t.n,
                   group_size=t.group_size, out_dtype=t.out_dtype)


def check_int4_matvec(results: list, gen, dev) -> None:
    """K2 against its f32 plain version at K2_CASES, weights drawn from
    `gen`.  Elementwise |y - ref| <= K2_TOL * max(1, max|ref|) + half a bf16
    ulp of |ref|: the sums' order, plus the kernel's one rounding of y to
    bf16.  Times: cold (graph_ms over cold_copies of the weight: outside L2,
    as a decode step reads it) and warm (device_ms: one weight replayed) for
    the kernel and for torch._weight_int4pack_mm; and the kernels one call
    launches, which must be 1."""
    import functools

    import torch

    from mlx_vlm_tpu_torch.ops import int4_matvec as iv

    for M, K, N, g in K2_CASES:
        t = random_int4(K, N, gen, dev, g)
        x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
        y = iv.int4_matvec_rows(x, t)
        ref = iv.int4_matvec_plain(x, t)
        torch.cuda.synchronize()
        diff = (y.float() - ref).abs()
        slack = (K2_TOL * max(1.0, float(ref.abs().max()))
                 + half_ulp_bf16(ref))
        ok = (y.dtype == torch.bfloat16 and tuple(y.shape) == (M, N)
              and bool((diff <= slack).all()))
        err, worst = float(diff.max()), float((diff / slack).max())
        run = functools.partial(iv.int4_matvec_rows, x)
        kernels = kernels_per_call(lambda: run(t))
        ok = ok and kernels == 1
        copies = [t] + [clone_int4(t) for _ in range(cold_copies(
            t.qp.numel() + 4 * t.sl.numel() * 4) - 1)]
        cold = graph_ms([functools.partial(run, c) for c in copies], iters=5)
        del copies
        warm = device_ms(lambda: run(t))
        plain_ms = device_ms(lambda: iv.int4_matvec_plain(x, t), iters=5)
        call = call_ms(lambda: run(t))
        lib = grouped_int4pack_mm(t, x)
        lib_cold = lib_warm = None
        lib_txt = " library: refused"
        if lib is not None:
            lib_err = float((lib().float() - ref).abs().max())
            lib_warm = device_ms(lib)
            _, w, _, sz = lib.args
            lib_cold = graph_ms(int4pack_copies(lib, cold_copies(
                w.numel() * w.element_size()
                + sz.numel() * sz.element_size())), iters=5)
            lib_txt = (f" library_ms={lib_cold:.4f} cold {lib_warm:.4f} "
                       f"warm (library max_abs_err={lib_err:.3e})")
        bound_ms, bound_by = bound(*int4_work(M, t, 2))
        shape = f"M={M} K={K} N={N}" + (f" g={g}" if g != 64 else "")
        print(f"  int4_matvec {shape}: max_abs_err={err:.3e} (worst "
              f"|err|/slack {worst:.3f}) kernel_ms={cold:.4f} cold "
              f"{warm:.4f} warm plain_ms={plain_ms:.4f}{lib_txt} (device "
              f"time) bound_ms={bound_ms:.5f} ({bound_by}) kernels per call "
              f"{kernels} (graph nodes) kernel_call_ms={call:.4f} (eager, "
              f"host included) {'ok' if ok else 'MISMATCH'}", flush=True)
        results.append({"name": "int4_matvec", "shape": shape, "err": err,
                        "err_over_slack": worst, "ms": cold, "warm_ms": warm,
                        "plain_ms": plain_ms, "call_ms": call,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_cold, "library_warm_ms": lib_warm,
                        "kernels_per_call": kernels, "ok": ok})
        del t, x, y, ref, lib


# K5 cases (bits, group size, M, K, N): the 7B linears at M = 1 (a decode
# step) and 512 (a prefill chunk), the 8-bit GEMM at request (h)'s one
# 58-row prefill chunk (all four linear shapes), the lm_head at M = 1, and
# mlx's other group sizes; for the GEMV route (M <= 8) also M = 2, 4 and 8
# at 3584^2 and at N = 18944 (batched decode), g = 32 and 128 at M = 1 and a
# ragged N = 1000 at M = 1 and 5; for the GEMM route at both widths a
# ragged chunk (M = 100, N = 1000) and a narrow one at g = 32 (both split
# K)
K5_CASES = (tuple((bits, 64, M, K, N) for bits in (4, 8) for M in (1, 512)
                  for K, N in K1_SHAPES)
            + ((8, 64, 58, 3584, 3584), (8, 64, 58, 3584, 18944),
               (8, 64, 58, 3584, 512), (8, 64, 58, 18944, 3584))
            + tuple((bits, 64, 1, 3584, 152064) for bits in (4, 8))
            + tuple((bits, 64, M, K, N) for bits in (4, 8) for M in (2, 4, 8)
                    for K, N in ((3584, 3584), (3584, 18944)))
            + tuple((bits, g, 1, 3584, 3584) for bits in (4, 8)
                    for g in (32, 128))
            + tuple((bits, 64, M, 3584, 1000) for bits in (4, 8)
                    for M in (1, 5))
            + tuple((bits, g, 512, 3584, 3584) for bits in (4, 8)
                    for g in (32, 128))
            + tuple(case for bits in (4, 8)
                    for case in ((bits, 64, 100, 3584, 1000),
                                 (bits, 32, 512, 3584, 512)))
            # an odd number of groups a row (Qwen2-VL-72B's 8-bit down_proj,
            # K = 29568 at g = 128: 231; 29 at K = 3712): the GEMV in 2 / 8
            # chunks and in one (a persistent grid at N = 18945), N even and
            # odd (the arrays' last value copied alone), and the GEMM
            + tuple((8, 128, M, 29568, N) for M, N in ((1, 8192), (8, 8192),
                                                       (5, 1001), (58, 8192)))
            + tuple((8, 128, 1, 3712, N) for N in (1001, 18945)))
# Qwen3-VL-8B's linears in the exact mode (phase 4's (q1)-(q3)): q / o
# 4096^2, k / v N = 1024, gate / up N = 12288, down K = 12288, at M = 1 (a
# decode step) and 512 (a prefill chunk), and its lm_head (N = 151936) at
# M = 1; each timed cold and warm
QWEN3_8B_SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))
K5_8B_CASES = (tuple((4, 64, M, K, N) for M in (1, 512)
                     for K, N in QWEN3_8B_SHAPES)
               + ((4, 64, 1, 4096, 151936),))
# Qwen3-VL-30B-A3B's experts (4 bits, g = 64): gate / up [768, 2048] and
# down [2048, 768] an expert, on the GEMV and the GEMM at M = 1, 8 and 32
# (an expert's rows in a 512-token prefill chunk: 512 * 8 / 128), and its
# 8-bit router [128, 2048] at M = 1 and 512; each timed cold and warm
MOE_SHAPES = ((2048, 768), (768, 2048))
K5_MOE_CASES = (tuple((4, 64, M, K, N) for M in (1, 8, 32)
                      for K, N in MOE_SHAPES)
                + tuple((8, 64, M, 2048, 128) for M in (1, 512)))
# the 8-bit GEMM's trailing half stage (g = 32, K an odd multiple of 32):
# K = 3616 (113 groups) at a 58-row chunk (row tile 64), at 512 rows (row
# tile 128), on a ragged 100-row chunk that splits K (N = 1000), and K = 96
K5_HALF_CASES = ((8, 32, 58, 3616, 3584), (8, 32, 512, 3616, 3584),
                 (8, 32, 100, 3616, 1000), (8, 32, 16, 96, 512))
# Llama-3.1-8B's linears and head in the exact mode ((t1)-(t3)): k / v
# N = 1024 (Qwen3-VL-8B's k / v rows above), gate / up N = 14336, down
# K = 14336, its lm_head N = 128256; LLaVA-1.5-7B's ((v1), (v2); q / k / v /
# o 4096^2 as Qwen3-VL-8B's q / o): gate / up N = 11008, down K = 11008,
# its lm_head N = 32064; each at M = 1 and 512, timed cold and warm
LLAMA_8B_SHAPES = ((4096, 1024), (4096, 14336), (14336, 4096),
                   (4096, 128256))
LLAVA_7B_SHAPES = ((4096, 11008), (11008, 4096), (4096, 32064))
K5_LLAMA_CASES = tuple(
    (4, 64, M, K, N) for M in (1, 512)
    for K, N in LLAMA_8B_SHAPES + LLAVA_7B_SHAPES
    if (4, 64, M, K, N) not in K5_8B_CASES)
# the text MoE families in the exact mode ((x1)-(x5) load Qwen3-30B-A3B
# by default, (y1) Mixtral-8x7B also exact; phase 3 holds all six): the
# 8-bit routers [E, D] of Mixtral (8 x 4096), Phi-3.5-MoE (16 x 4096),
# Granite 3.0 (40 x 1536), Qwen1.5-MoE (60 x 2048) and OLMoE (64 x 2048),
# and Qwen1.5-MoE's shared-expert gate (N = 1, K = 2048) at 8 and 4 bits,
# at M = 1 and 512; Qwen3-30B-A3B's q / k / v / o (2048 -> 4096, 512;
# 4096 -> 2048) at M = 1 and 512 and its lm_head (N = 151936) and
# Mixtral's (N = 32000) at M = 1; each timed cold and warm
MOE_ROUTERS = ((4096, 8), (4096, 16), (1536, 40), (2048, 60), (2048, 64),
               (2048, 1))
K5_MOE_TEXT_CASES = (
    tuple((8, 64, M, K, N) for M in (1, 512) for K, N in MOE_ROUTERS)
    + tuple((4, 64, M, 2048, 1) for M in (1, 512))
    + tuple((4, 64, M, K, N) for M in (1, 512)
            for K, N in ((2048, 4096), (2048, 512), (4096, 2048)))
    + ((4, 64, 1, 2048, 151936), (4, 64, 1, 4096, 32000)))
# the target-coupled drafters' verifies on Llama-3.1-8B exact ((z)):
# q / o, k / v, gate / up, down and the head at M = 5 (EAGLE-3 / MTP, k =
# 4, on the GEMV), 9 (DDTree's [bonus | 8 nodes]) and 16 (DFlash's block),
# and the head at M = 15 (DFlash's draft rows); each timed cold and warm
K5_DRAFT_CASES = tuple(
    (4, 64, M, K, N) for M in (5, 9, 16)
    for K, N in ((4096, 4096),) + LLAMA_8B_SHAPES) + (
    (4, 64, 15, 4096, 128256),)
# PaliGemma2-3B's linears and head in the exact mode ((p1), (p2); K =
# 2304 is 36 groups): q N = 2048, k / v N = 1024, o K = 2048, gate / up N =
# 9216, down K = 9216, the tied head N = 257216, at M = 1 and 512;
# PaliGemma-3B's ((p3)) k / v N = 256 at M = 1 and 512 and its head (K =
# 2048) at M = 1; each timed cold and warm
PALIGEMMA2_3B_SHAPES = ((2304, 2048), (2304, 1024), (2048, 2304),
                        (2304, 9216), (9216, 2304), (2304, 257216))
K5_PALIGEMMA_CASES = (
    tuple((4, 64, M, K, N) for M in (1, 512)
          for K, N in PALIGEMMA2_3B_SHAPES)
    + tuple((4, 64, M, 2048, 256) for M in (1, 512))
    + ((4, 64, 1, 2048, 257216),))
# gpt-oss-20b's linears ((o1)-(o3)): K = 2880 is 45 groups of 64, an odd
# count.  At 4 bits the reference's rule sends q (N = 4096), k / v (N =
# 512), the router (N = 32) and the head (N = 201088) to its dequantize
# route (a row of 1440 code bytes holds no whole number of 64-byte group
# pairs), so the port does too; K5 takes them at 8 bits, held here at M =
# 1 and 512; o (K = 4096, N = 2880) runs K5 at 4 bits.  phi-2's ((r1),
# (r2); K = 2560, 40 groups): q / k / v / dense N = 2560, fc1 N = 10240,
# fc2 K = 10240, the biased head N = 51200, at M = 1 and 512.  Each timed
# cold and warm (the router warm only)
GPT_OSS_2880_SHAPES = ((2880, 4096), (2880, 512), (2880, 32),
                       (2880, 201088))
K5_GPT_OSS_CASES = (tuple((8, 64, M, K, N) for M in (1, 512)
                          for K, N in GPT_OSS_2880_SHAPES)
                    + tuple((4, 64, M, 4096, 2880) for M in (1, 512)))
PHI_2_SHAPES = ((2560, 2560), (2560, 10240), (10240, 2560), (2560, 51200))
K5_PHI_2_CASES = tuple((4, 64, M, K, N) for M in (1, 512)
                       for K, N in PHI_2_SHAPES)
K5_CASES = (K5_CASES + K5_8B_CASES + K5_MOE_CASES + K5_HALF_CASES
            + K5_LLAMA_CASES + K5_MOE_TEXT_CASES + K5_DRAFT_CASES
            + K5_PALIGEMMA_CASES + K5_GPT_OSS_CASES + K5_PHI_2_CASES)
K5_TOL = 1e-2


def random_mlx(bits: int, g: int, K: int, N: int, gen, dev,
               lead: tuple = ()):
    """Random mlx-layout weight [*lead, N, K] (lead (E,): a stack of E
    experts), as utils/testing's mlx_quantized_checkpoint draws them: codes
    uniform over [0, 2**bits), bf16 scales around the value that gives the
    dequantized weights std 0.02, biases -((2**bits - 1) / 2) * scale."""
    import torch

    from mlx_vlm_tpu_torch.core.quant import QuantizedTensor

    levels = 2**bits
    s_mean = 0.02 / math.sqrt((levels**2 - 1) / 12.0)
    q = torch.randint(0, 256, (*lead, N, K * bits // 8), generator=gen,
                      device=dev, dtype=torch.uint8)
    s = s_mean * (0.75 + 0.5 * torch.rand((*lead, N, K // g), generator=gen,
                                          device=dev))
    return QuantizedTensor(q=q, scales=s.to(torch.bfloat16),
                           biases=(-(levels - 1) / 2 * s).to(torch.bfloat16),
                           bits=bits, group_size=g, out_dtype="bfloat16")


def qmm_work(M: int, t) -> tuple:
    """(bytes, operations) of x [M, K] bf16 @ dequant(t).T: x, the codes and
    the bf16 scales and biases read once, the bf16 output written once."""
    N, K = t.q.shape[0], t.q.shape[1] * 8 // t.bits
    nbytes = M * K * 2 + t.q.numel() + 2 * t.scales.numel() * 2 + M * N * 2
    return nbytes, 2.0 * M * N * K


def clone_mlx(t):
    """A copy of a QuantizedTensor in fresh device memory."""
    return type(t)(q=t.q.clone(), scales=t.scales.clone(),
                   biases=t.biases.clone(), bits=t.bits,
                   group_size=t.group_size, out_dtype=t.out_dtype)


def qmm_cold_ms(run, t) -> float:
    """Device time of run(t) with the weight cold in L2: graph_ms over
    cold_copies of t, as a prefill chunk or a decode step reads it."""
    import functools

    copies = [t] + [clone_mlx(t) for _ in range(cold_copies(
        t.q.numel() + 2 * t.scales.numel() * 2) - 1)]
    return graph_ms([functools.partial(run, c) for c in copies], iters=5)


def time_k5(cases, dev, outputs=None) -> None:
    """Cold (qmm_cold_ms) and warm (device_ms) device times of K5's wrapper
    at `cases` (bits, group size, M, K, N), one printed line a case.  It
    calls only `quantized_matmul_kernel`, so it times the K5 of whichever
    tree the package is imported from: run from an unpacked parent, it
    puts the parent's times beside this tree's in one call.  Inputs come
    from a fixed seed, so that `outputs` (a dict, filled with each case's
    output on the CPU) can hold two trees' results to the bit."""
    import functools

    import torch

    from mlx_vlm_tpu_torch.ops import qmatmul as k5

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    for bits, g, M, K, N in cases:
        t = random_mlx(bits, g, K, N, gen, dev)
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        run = functools.partial(k5.quantized_matmul_kernel, x)
        if outputs is not None:
            outputs[(bits, g, M, K, N)] = run(t).cpu()
        cold, warm = qmm_cold_ms(run, t), device_ms(lambda: run(t))
        bound_ms, bound_by = bound(*qmm_work(M, t))
        shape = f"M={M} K={K} N={N} g={g}"
        print(f"  time_k5 qmatmul_int{bits} {shape}: kernel_ms={cold:.4f} "
              f"cold {warm:.4f} warm bound_ms={bound_ms:.5f} ({bound_by})",
              flush=True)
        del t, x


def check_qmatmul(results: list, dev) -> None:
    """K5 against its plain version at K5_CASES, its weights drawn on the
    card; 4-bit cases also time torch._weight_int4pack_mm.  No single
    PyTorch call takes 8-bit group-affine codes (_weight_int8pack_mm is
    per-channel, with no group bias), so the 8-bit cases have none.  GEMV
    cases (M <= 8) and the GEMM's 58-row cases (request (h)'s prefill
    chunk) are timed cold (qmm_cold_ms: the weight outside L2, as a decode
    step or a chunk reads it) and warm (device_ms), the GEMV's library
    too.  Every case records the kernels one call launches (the GEMV one,
    the GEMM one or two where its plan splits K) and must give
    bit-identical output on a repeat."""
    import functools

    import torch

    from mlx_vlm_tpu_torch.ops import qmatmul as k5

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for bits, g, M, K, N in K5_CASES:
        t = random_mlx(bits, g, K, N, gen, dev)
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        lib = None
        if bits == 4:
            codes = torch.stack([t.q & 0xF, t.q >> 4], dim=-1).reshape(N, K)
            lib = int4pack_mm(codes, t.scales, t.biases, g, x)
        name, shape = f"qmatmul_int{bits}", f"M={M} K={K} N={N} g={g}"
        run = functools.partial(k5.quantized_matmul_kernel, x)
        out = run(t)
        _check(results, name, shape, out, k5.qmatmul_plain(x, t), K5_TOL,
               lambda: run(t), lambda: k5.qmatmul_plain(x, t), floor=0.0,
               work=qmm_work(M, t), library=lib)
        r = results[-1]
        weight_bytes = t.q.numel() + 2 * t.scales.numel() * 2
        cold = (M <= k5.MAX_GEMV_ROWS or M == 58
                or (bits, g, M, K, N) in (K5_8B_CASES + K5_MOE_CASES
                                          + K5_LLAMA_CASES
                                          + K5_MOE_TEXT_CASES
                                          + K5_DRAFT_CASES
                                          + K5_PALIGEMMA_CASES
                                          + K5_GPT_OSS_CASES
                                          + K5_PHI_2_CASES))
        if cold and cold_copies(weight_bytes) > MAX_COLD_COPIES:
            # a router's few KB: warm only (its cold timing would capture
            # tens of thousands of copies in one graph)
            print(f"  {name} {shape}: {weight_bytes} bytes of weight, timed "
                  f"warm only", flush=True)
        elif cold:
            r["warm_ms"], r["ms"] = r["ms"], qmm_cold_ms(run, t)
            txt = f"kernel_ms={r['ms']:.4f} cold {r['warm_ms']:.4f} warm"
            if lib is not None:
                _, w, _, sz = lib.args
                r["library_warm_ms"], r["library_ms"] = (
                    r["library_ms"], graph_ms(int4pack_copies(lib, cold_copies(
                        w.numel() * w.element_size()
                        + sz.numel() * sz.element_size())), iters=5))
                txt += (f" library_ms={r['library_ms']:.4f} cold "
                        f"{r['library_warm_ms']:.4f} warm")
            print(f"  {name} {shape}: {txt} (device time)", flush=True)
        if M <= k5.MAX_GEMV_ROWS:
            rt, chunks = k5.qmatmul_gemv_plan(M, K, N, bits, g)
            plan, want = f"GEMV {rt} row tile(s) a block, {chunks} chunk(s)", 1
        else:
            bm, splits = k5.qmatmul_plan(M, K, N, g, bits=bits)
            plan = f"GEMM row tile {bm}, {splits} K slice(s)"
            want = 1 if splits == 1 else 2
        kernels = kernels_per_call(lambda: run(t))
        same = bool(torch.equal(run(t), out))
        r["kernels_per_call"], r["plan"], r["repeat_identical"] = (
            kernels, plan, same)
        r["ok"] = r["ok"] and same and kernels == want
        print(f"  {name} {shape}: {plan}, kernels per call {kernels} "
              f"(graph nodes; want {want}), repeat bit-identical {same} "
              f"{'ok' if r['ok'] else 'MISMATCH'}", flush=True)
        del t, x, lib, out


# K5's expert-indexed entry at Qwen3-VL-30B-A3B's expert stacks (128
# experts, 4 bits, g = 64): the pairs of a B = 1 decode step (1 token x 8
# experts), a 4-slot batch step (32) and a speculative verify at M = 5 (40)
MOE_EXPERTS, MOE_TOP_K = 128, 8
EXPERT_PAIRS = (8, 32, 40)
# and at the text MoE families' stacks: (name, experts, top-k, hidden D,
# expert width I, pairs, group size); gate / up [E, I, D] with the tokens'
# rows, down [E, D, I] one row a pair.  Qwen3-30B-A3B's stacks are
# Qwen3-VL-30B-A3B's (the first row); Mixtral at a decode step (2 pairs)
# and a 4-slot batch step (8); Qwen1.5-MoE also at g = 128, where its
# down projection (K = 1408) has an odd number of groups a row
EXPERT_STACKS = (
    ("Qwen3-30B-A3B", MOE_EXPERTS, MOE_TOP_K, 2048, 768, EXPERT_PAIRS, 64),
    ("Mixtral-8x7B", 8, 2, 4096, 14336, (2, 8), 64),
    ("OLMoE-1B-7B", 64, 8, 2048, 1024, (8,), 64),
    ("Qwen1.5-MoE-A2.7B", 60, 4, 2048, 1408, (4,), 64),
    ("Qwen1.5-MoE-A2.7B", 60, 4, 2048, 1408, (4,), 128),
    ("Phi-3.5-MoE", 16, 2, 4096, 6400, (2,), 64),
    ("Granite-3.0-3B-A800M", 40, 8, 1536, 512, (8,), 64),
    # gpt-oss-20b: gate / up and down alike [32, 2880, 2880], 45 groups a
    # row at g = 64; a decode step (4 pairs) and a 4-slot batch step (16)
    ("gpt-oss-20b", 32, 4, 2880, 2880, (4, 16), 64),
)


def expert_work(t, experts, x_rows: int) -> tuple:
    """(bytes, operations) of one expert-indexed call: the codes, scales
    and biases of each expert the pairs name read once (this run's
    experts), x's rows read once, y [P, N] bf16 written once; 2 N K
    operations a pair."""
    E, N, K = t.shape
    distinct = len(set(experts.tolist()))
    per_expert = (t.q[0].numel() + 2 * t.scales[0].numel() * 2)
    P = experts.numel()
    return (distinct * per_expert + x_rows * K * 2 + P * N * 2,
            2.0 * P * N * K)


def check_qmatmul_experts(results: list, dev) -> None:
    """K5's expert-indexed entry (`quantized_matmul_experts`) against its
    plain version at each of EXPERT_STACKS: gate / up [E, I, D] (x: the
    tokens' rows, pair p reading token p // k) and down [E, D, I] (x: one
    row a pair), at the stack's pair counts, two pairs on expert E - 1;
    tolerance K5_TOL * max|ref| (both round once to bf16 after f32 sums).
    Each case is timed cold (`graph_ms` over copies of the stack that
    together pass COLD_BYTES of the experts it reads) and warm, with its
    kernels per call (must be 1), a bit-identical repeat and its bytes per
    second beside the bound.  No PyTorch call gathers experts from
    mlx-affine codes, so there is no library time."""
    import functools

    import torch

    from mlx_vlm_tpu_torch.ops import qmatmul as k5

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    for model, E, top_k, D, I, pair_counts, g in EXPERT_STACKS:
        stacks = [(K, N, down, random_mlx(4, g, K, N, gen, dev, (E,)))
                  for down, (K, N) in enumerate(((D, I), (I, D)))]
        for P in pair_counts:
            experts = torch.randint(0, E, (P,), generator=gen, device=dev,
                                    dtype=torch.int32)
            experts[0] = experts[1] = E - 1
            tokens = P // top_k
            token_rows = (torch.arange(P, device=dev) // top_k).to(
                torch.int32)
            for K, N, down, t in stacks:
                rows = None if down else token_rows
                x = torch.randn((tokens if rows is not None else P, K),
                                generator=gen, device=dev).to(torch.bfloat16)
                run = functools.partial(k5.quantized_matmul_experts, x,
                                        experts=experts, rows=rows)
                out = run(t)
                name = "qmatmul_experts"
                shape = (f"P={P} E={E} K={K} N={N} g={g}"
                         + (" down" if down and D == I else ""))
                work = expert_work(t, experts, x.shape[0])
                _check(results, name, shape, out,
                       k5.qmatmul_experts_plain(x, t, experts, rows), K5_TOL,
                       lambda: run(t),
                       lambda: k5.qmatmul_experts_plain(x, t, experts, rows),
                       floor=0.0, work=work)
                r = results[-1]
                copies = [t] + [clone_mlx(t) for _ in range(
                    cold_copies(work[0]) - 1)]
                r["warm_ms"] = r["ms"]
                r["ms"] = graph_ms([functools.partial(run, c)
                                    for c in copies], iters=5)
                del copies
                kernels = kernels_per_call(lambda: run(t))
                same = bool(torch.equal(run(t), out))
                r["kernels_per_call"], r["repeat_identical"] = kernels, same
                r["model"] = model
                r["ok"] = r["ok"] and same and kernels == 1
                print(f"  {name} {model} {shape}: kernel_ms={r['ms']:.4f} "
                      f"cold {r['warm_ms']:.4f} warm (device time); "
                      f"{len(set(experts.tolist()))} experts read, "
                      f"{work[0] / 1e6:.3f} MB, "
                      f"{work[0] / r['ms'] / 1e9:.3f} TB/s cold against the "
                      f"bound's 3.35 (bound_ms={r['bound_ms']:.5f}); kernels "
                      f"per call {kernels} (want 1), repeat bit-identical "
                      f"{same} {'ok' if r['ok'] else 'MISMATCH'}",
                      flush=True)
        del stacks


def check_route_repairs(dev) -> bool:
    """The route rules held to their kernels' limits, each at the shape
    that its kernel refused, on the card: K4 (flash_eligible) sends head
    size 64 to `sdpa`, which matches K4's plain version; K5's rule sends
    group 16 to the dequantize route, which matches K5's plain version;
    the w4grp fold makes a 4-bit triple of group 24 per-channel int8, whose
    product on the card matches its plain version on the CPU.  (The 8-bit
    GEMM's half stage is among K5_HALF_CASES.)"""
    import numpy as np
    import torch

    from mlx_vlm_tpu_torch.core import cache as cache_lib
    from mlx_vlm_tpu_torch.core import quant as tq
    from mlx_vlm_tpu_torch.core.mask import causal_cache_mask
    from mlx_vlm_tpu_torch.ops import flash_attention as fa
    from mlx_vlm_tpu_torch.ops import qmatmul as k5
    from mlx_vlm_tpu_torch.utils import loader

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    ok = True
    # K4: head size 64 against a cache of 8192, a 512-row chunk at 7680
    B, H, KVH, S, C, D = 1, 8, 2, 512, 8192, 64
    cache = cache_lib.init_cache(1, B, KVH, D, C, torch.bfloat16, device=dev)
    cache.offset.fill_(7680)
    q, k, v = (torch.randn((B, n, S, D), generator=gen, device=dev).to(
        torch.bfloat16) for n in (H, KVH, KVH))
    before = fa.launches["flash_attention"]
    routed = cache_lib.flash_eligible(q, cache.k[0])
    mask = causal_cache_mask(cache.offset, cache.left_pad, S, C)
    out = cache.attend(0, q, k, v, D ** -0.5, mask)
    ref = fa.flash_attention_plain(q, cache.k[0], cache.v[0],
                                   cache.offset.expand(B), cache.left_pad,
                                   D ** -0.5)
    err = float((out.float() - ref.float()).abs().max())
    tol = FLASH_TOL * float(ref.float().abs().max())
    k4_ok = (not routed and fa.launches["flash_attention"] == before
             and err <= tol)
    wide = cache_lib.flash_eligible(q.new_empty((B, H, S, 128)), cache.k[0])
    k4_ok = k4_ok and wide
    print(f"  route repair K4: head_dim {D}, S={S} C={C}: flash_eligible "
          f"{routed} (at head_dim 128: {wide}); sdpa vs K4's plain version "
          f"max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if k4_ok else 'MISMATCH'}", flush=True)
    ok = ok and k4_ok
    # K5: group 16 takes the dequantize route
    t = random_mlx(4, 16, 2048, 512, gen, dev)
    x = torch.randn((8, 2048), generator=gen, device=dev).to(torch.bfloat16)
    before = dict(k5.launches)
    out = tq.quantized_matmul(x, t)
    ref = k5.qmatmul_plain(x, t)
    err = float((out.float() - ref.float()).abs().max())
    tol = K5_TOL * float(ref.float().abs().max())
    k5_ok = (not tq.qmm_kernel_route(t) and k5.launches == before
             and err <= tol)
    print(f"  route repair K5: group 16, M=8 K=2048 N=512: qmm_kernel_route "
          f"{tq.qmm_kernel_route(t)}, dequantize route vs K5's plain version "
          f"max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if k5_ok else 'MISMATCH'}", flush=True)
    ok = ok and k5_ok
    # K5 at gpt-oss-20b's K = 2880 (45 groups of 64): at 4 bits the rule
    # sends a 2-D weight to the dequantize route, and the expert-indexed
    # entry takes the [32, 2880, 2880] stacks
    t = random_mlx(4, 64, 2880, 512, gen, dev)
    x = torch.randn((8, 2880), generator=gen, device=dev).to(torch.bfloat16)
    before = dict(k5.launches)
    out = tq.quantized_matmul(x, t)
    ref = k5.qmatmul_plain(x, t)
    err = float((out.float() - ref.float()).abs().max())
    tol = K5_TOL * float(ref.float().abs().max())
    stack = random_mlx(4, 64, 2880, 2880, gen, dev, (32,))
    oss_ok = (not tq.qmm_kernel_route(t) and k5.launches == before
              and err <= tol and k5.experts_kernel_route(stack))
    print(f"  route rule K5 at gpt-oss-20b's K=2880, 4 bits g=64: "
          f"qmm_kernel_route {tq.qmm_kernel_route(t)}, dequantize route vs "
          f"K5's plain version max_abs_err={err:.3e} tol={tol:.3e}; "
          f"experts_kernel_route([32, 2880, 2880]) "
          f"{k5.experts_kernel_route(stack)} "
          f"{'ok' if oss_ok else 'MISMATCH'}", flush=True)
    ok = ok and oss_ok
    del stack
    # K1 / K2: a 4-bit triple of group 24 folds per-channel under w4grp
    rng = np.random.default_rng(SEED + 16)
    w = rng.integers(0, 2**32, (256, 96 * 4 // 32), dtype=np.uint32)
    s = torch.from_numpy(rng.uniform(1e-3, 2e-3, (256, 4)).astype(
        np.float32)).to(torch.bfloat16)
    folded = loader._fold_triple(w, s, -7.5 * s, 4, 24, "w4grp", False)
    x = torch.randn((3, 96)).to(torch.bfloat16)

    def on(device):
        return tq.ChannelQuantizedTensor(
            q8=folded.q8.to(device), scales=folded.scales.to(device),
            biases=folded.biases.to(device), src_bits=4,
            out_dtype="bfloat16")

    out = tq.channel_quantized_matmul(x.to(dev), on(dev)).cpu().float()
    ref = tq.channel_quantized_matmul(x, on("cpu")).float()
    err = float((out - ref).abs().max())
    tol = K5_TOL * float(ref.abs().max())
    k12_ok = isinstance(folded, tq.ChannelQuantizedTensor) and err <= tol
    print(f"  route repair K1/K2: 4-bit group 24 under w4grp folds to "
          f"{type(folded).__name__}; its product on the card vs the CPU's "
          f"f32 max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if k12_ok else 'MISMATCH'}", flush=True)
    return ok and k12_ok


def phase_kernels() -> list:
    """Each kernel against its plain version on the card at 7B shapes."""
    import torch

    from mlx_vlm_tpu_torch.ops import flash_attention as fa
    from mlx_vlm_tpu_torch.ops import int4_matvec as iv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    results: list = []
    print("phase 2: kernels vs plain versions (tolerances: K1 and K5 "
          "1e-2*max|ref| since kernel and plain version each round once to "
          "bf16 (one ulp is at most 2^-7*max|ref|) after f32 sums that "
          "differ by reassociation only, K4 2e-2*max|ref| for bf16 output "
          "rounding, K2 elementwise 1e-3*max(1,max|ref|) for summation order "
          "+ half a bf16 ulp of |ref| for its one rounding of y, K3 "
          "1e-4*max|ref| on the first layer's k/v and 6e-2*max|ref| behind "
          "bf16 roundings that the layers amplify, K6-K8 1e-2*max|ref| for "
          "bf16(p*vs) rounded against block-local maxima)", flush=True)
    weights = {}
    for K, N in K1_SHAPES:
        weights[(K, N)] = random_int4(K, N, gen, dev)
    k1_cases = [(512, K, N, 64, weights[(K, N)]) for K, N in K1_SHAPES]
    k1_cases += [(M, K, N, g, random_int4(K, N, gen, dev, g))
                 for M, K, N, g in K1_EXTRA]
    for M, K, N, g, t in k1_cases:
        x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
        _check(results, "int4_matmul",
               f"M={M} K={K} N={N}" + (f" g={g}" if g != 64 else ""),
               iv.int4_matmul(x, t), iv.int4_matmul_plain(x, t), K1_TOL,
               lambda: iv.int4_matmul(x, t), lambda: iv.int4_matmul_plain(x, t),
               floor=0.0, work=int4_work(M, t, 2),
               library=grouped_int4pack_mm(t, x))
    del k1_cases, weights
    check_int4_matvec(results, gen, dev)
    check_qmatmul(results, dev)
    check_qmatmul_experts(results, dev)
    if not check_route_repairs(dev):
        fail("a route rule sends a shape its kernel refuses, or its route "
             "disagrees with the plain version")
    check_flash_attention(results, gen, dev)
    check_fused_decode(results, gen, dev)
    check_fused_decode_2b(results, gen, dev)
    check_kv_kernels(results, gen, dev)
    check_k6_paligemma(results, gen, dev)
    return results


# K4's cases: (B, C, offsets, left_pads, window, q_scale, (H, KVH)), all
# at D = 128, S = 512, H = 28 and KVH = 4 but the last (12 and 2, the 2B
# drafter's heads).  The first three are the 8k rows: offset 7680,
# then left_pad 100, then a 1024-column window.  Then (c)'s first, middle
# and last 512-row chunk against its 8704-slot cache (offset 0 cuts the
# causal diagonal through every block), and two batch rows with their own
# offsets and a left_pad inside a tile.  q_scale 4 sharpens the scores (std
# 4), so that a cache column masked wrongly (left_pad, window) moves the
# output far past the tolerance; every row sees at least one key.
FLASH_CASES = tuple(case + ((28, 4),) for case in (
    (1, 8192, (7680,), (0,), None, 1),
    (1, 8192, (7680,), (100,), None, 4),
    (1, 8192, (7680,), (100,), 1024, 4),
    (1, 8704, (0,), (0,), None, 1),
    (1, 8704, (4096,), (0,), None, 1),
    (1, 8704, (8192,), (0,), None, 1),
    (2, 8704, (4096, 2900), (0, 1061), None, 4),
)) + (
    # the 2B drafter's last chunk of (s3)'s prompt: 12 heads over 2 KV
    # heads, a GQA group of 6
    (1, 8704, (8192,), (0,), None, 1, (12, 2)),
    # Qwen3-VL-8B's last chunk of (q2)'s ~8.5k-token prompt: 32 heads over
    # 8 KV heads
    (1, 8704, (8192,), (0,), None, 1, (32, 8)),
)
FLASH_TOL = 2e-2


def _csv(values) -> str:
    return ",".join(map(str, values))


def check_flash_attention(results: list, gen, dev) -> None:
    """K4 against its plain version at FLASH_CASES (2e-2 * max|ref|, no
    floor), beside F.scaled_dot_product_attention on the same boolean mask.
    Each case also records the kernels one call puts in a captured
    graph (one: K4 has no combine pass), whether a repeat call gives the
    same bits, and a cold time: `graph_ms` over `cold_copies` of k/v
    (17.8 MB a pair at B = 1, together past 100 MB), so each call finds
    its cache outside the 50 MB L2, as a prefill does after 27 layers'
    weights."""
    import functools

    import torch

    from mlx_vlm_tpu_torch.ops import flash_attention as fa

    D, S = 128, 512
    scale = D ** -0.5
    q1 = kv = None
    for B, C, offs, lps, window, q_scale, (H, KVH) in FLASH_CASES:
        if q1 is None or q1.shape[:2] != (B, H) or kv[0].shape[1:3] != (KVH,
                                                                         C):
            q1 = torch.randn((B, H, S, D), generator=gen)
            kv = [torch.randn((B, KVH, C, D), generator=gen).to(
                dev, torch.bfloat16) for _ in range(2)]
        k, v = kv
        q = (q1 * q_scale).to(dev, torch.bfloat16)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        lp = torch.tensor(lps, dtype=torch.int32, device=dev)
        mask = flash_mask(off, lp, S, C, window)
        run = lambda kc=k, vc=v: fa.flash_attention(q, kc, vc, off, lp,
                                                     scale, window)
        out = run()
        plain = lambda: fa.flash_attention_plain(q, k, v, off, lp, scale,
                                                 window)
        _check(results, "flash_attention",
               f"B={B} H={H} KVH={KVH} D={D} S={S} C={C} offset="
               f"{_csv(offs)} left_pad={_csv(lps)} "
               f"window={window} q_scale={q_scale}",
               out, plain(), FLASH_TOL, run, plain, floor=0.0,
               work=flash_work(mask, H, KVH, D),
               library=lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, scale=scale, enable_gqa=True))
        r = results[-1]
        kernels = kernels_per_call(run)
        same = bool(torch.equal(run(), out))
        pair = 2 * k.numel() * k.element_size()
        copies = [(k, v)] + [(k.clone(), v.clone())
                             for _ in range(cold_copies(pair) - 1)]
        r["warm_ms"], r["ms"] = r["ms"], graph_ms(
            [functools.partial(run, kc, vc) for kc, vc in copies], iters=5)
        del copies
        r["kernels_per_call"], r["repeat_identical"] = kernels, same
        r["ok"] = r["ok"] and same and kernels == 1
        print(f"  flash_attention {r['shape']}: kernel_ms={r['ms']:.4f} cold "
              f"{r['warm_ms']:.4f} warm (device time), kernels per call "
              f"{kernels} (graph nodes), repeat bit-identical {same} "
              f"{'ok' if r['ok'] else 'MISMATCH'}", flush=True)


def flash_mask(offset, left_pad, S: int, C: int, window):
    """K4's visibility as a boolean mask [B, 1, S, C] (True = attend)."""
    import torch

    dev = offset.device
    pos = offset.long()[:, None] + torch.arange(S, device=dev)
    col = torch.arange(C, device=dev)
    keep = (col[None, None] <= pos[:, :, None]) & (
        col[None, None] >= left_pad.long()[:, None, None])
    if window is not None:
        keep &= col[None, None] > pos[:, :, None] - window
    return keep[:, None]


def flash_work(mask, H: int, KVH: int, D: int) -> tuple:
    """(bytes, operations) of K4 on this data: q and o once, each KV head's
    k and v over the columns some row sees, and 4 * D operations per
    visible (row, head, column)."""
    B, _, S, _ = mask.shape
    cols = int(mask.any(dim=2).sum())
    visible = float(mask.sum()) * H
    return 2 * B * H * S * D * 2 + 2 * KVH * cols * D * 2, 4.0 * D * visible


FUSED_LAYERS, FUSED_CAPACITY = 4, 8704
# K3's cases: (offset, what fills the cache past the cursor)
FUSED_CASES = ((1, 1e3), (300, 1e3), (8545, 1e3), (8545, float("nan")))
# K3 tolerances, relative to max|ref| of each output, no floor.  EXACT holds
# the first layer's k/v rows, which see no rounded intermediate.  Every
# later output sits behind bf16 roundings of x before each weight dot, and
# the random 7B stack amplifies a flipped rounding: the plain version itself
# moves these outputs by up to 2.6e-2 * max|ref| when cos is perturbed by one
# part in 1e6 (NVIDIA H100 80GB HBM3, 4 layers, offset 8545), so ROUNDED is set at
# about twice that floor, which the check prints beside each error.
FUSED_EXACT, FUSED_ROUNDED = 1e-4, 6e-2


def fused_params(n_layers: int, gen, dev, q_scale: float, cfg=None):
    """(language-model params, TextConfig) at the widths of `cfg` (a
    Qwen2-VL config dict; Qwen2-VL-7B's by default) with `n_layers` random
    int4 decoder layers and an int4 lm_head; q_proj's planes and bias are
    scaled by q_scale (sharper attention scores)."""
    import torch

    from mlx_vlm_tpu_torch.core.quant import Int4GroupedTensor
    from mlx_vlm_tpu_torch.models.qwen2_vl import ModelConfig
    from mlx_vlm_tpu_torch.utils.testing import qwen2_vl_7b_config

    cfg = dict(cfg or qwen2_vl_7b_config())
    cfg["num_hidden_layers"] = n_layers
    args = ModelConfig.from_dict(cfg).text_config
    D, I = args.hidden_size, args.intermediate_size
    nkv = args.num_key_value_heads * (D // args.num_attention_heads)
    bf16 = torch.bfloat16

    def stacked(K, N, scale=1.0):
        ts = [random_int4(K, N, gen, dev) for _ in range(n_layers)]
        return Int4GroupedTensor(
            qp=torch.stack([t.qp for t in ts]),
            **{f: torch.stack([getattr(t, f) for t in ts]) * scale
               for f in ("sl", "sh", "bl", "bh")},
            n=N, group_size=64, out_dtype="bfloat16")

    def small(*shape, mean=0.0, std=0.02):
        return (mean + std * torch.randn(shape, generator=gen)).to(dev, bf16)

    layers = {
        "input_layernorm": {"weight": small(n_layers, D, mean=1, std=0.1)},
        "post_attention_layernorm": {
            "weight": small(n_layers, D, mean=1, std=0.1)},
        "self_attn": {
            "q_proj": {"weight": stacked(D, D, q_scale),
                       "bias": small(n_layers, D, std=0.02 * q_scale)},
            "k_proj": {"weight": stacked(D, nkv),
                       "bias": small(n_layers, nkv)},
            "v_proj": {"weight": stacked(D, nkv),
                       "bias": small(n_layers, nkv)},
            "o_proj": {"weight": stacked(D, D)},
        },
        "mlp": {"gate_proj": {"weight": stacked(D, I)},
                "up_proj": {"weight": stacked(D, I)},
                "down_proj": {"weight": stacked(I, D)}},
    }
    params = {"model": {"layers": layers,
                        "norm": {"weight": small(D, mean=1, std=0.1)}},
              "lm_head": {"weight": random_int4(D, args.vocab_size, gen,
                                                dev)}}
    return params, args


def fused_step_bytes(params: dict, args, offset: int) -> int:
    """Bytes one K3 step must read: int4 codes and f32 scale planes of the
    seven layer linears and the fused head, and the bf16 k/v history
    [0, offset)."""
    from mlx_vlm_tpu_torch.ops import fused_decode as fd

    ws = [p["weight"] for p in fd._linears(params)]
    head = fd.fused_head(params, args)
    if head is not None:
        ws.append(head)
    n = sum(w.qp.numel() + 4 * 4 * w.sl.numel() for w in ws)
    L = ws[0].qp.shape[0]
    hd = args.hidden_size // args.num_attention_heads
    return n + 2 * L * args.num_key_value_heads * offset * hd * 2


def fused_step_ops(params: dict, args, offset: int) -> float:
    """Operations of one K3 step: two per int4 weight (each code byte holds
    two) and 4 * hd per head and history token in each layer."""
    from mlx_vlm_tpu_torch.ops import fused_decode as fd

    ws = [p["weight"] for p in fd._linears(params)]
    head = fd.fused_head(params, args)
    if head is not None:
        ws.append(head)
    L = ws[0].qp.shape[0]
    hd = args.hidden_size // args.num_attention_heads
    return (4.0 * sum(w.qp.numel() for w in ws)
            + 4.0 * L * args.num_attention_heads * hd * offset)


# K3 at the 2B drafter's widths (the single-stream drafter's steps in
# phase 4's speculative part): hidden 1536, 12 / 2 heads (6 q heads a kv
# head), intermediate 8960, the 7B's vocabulary 152064, all 28 layers and
# the head, at two offsets
FUSED_2B_CASES = ((300, 1e3), (8545, 1e3))


def drafter_config() -> dict:
    """qwen2_vl_2b_config() with the 7B target's vocabulary, 152064: both
    packages refuse the published 2B vocabulary (151936) beside the 7B
    target, since validate_drafter_compatibility compares vocab sizes."""
    from mlx_vlm_tpu_torch.utils.testing import qwen2_vl_2b_config

    cfg = qwen2_vl_2b_config()
    cfg["vocab_size"] = 152064
    return cfg


def check_fused_decode_2b(results: list, gen, dev) -> None:
    """K3 at the drafter's widths (check_fused_decode at FUSED_2B_CASES
    with all 28 layers and the head), after printing the kernel's refusal
    rule and its ring plan at that width."""
    from mlx_vlm_tpu_torch.models.qwen2_vl import ModelConfig
    from mlx_vlm_tpu_torch.ops import fused_decode as fd

    cfg = drafter_config()
    args = ModelConfig.from_dict(cfg).text_config
    refusal = fd.kernel_refusal(args, 64, args.intermediate_size)
    print(f"  fused_decode at the 2B's widths: kernel_refusal {refusal}; "
          f"ring {fd._ring(args.hidden_size, 64)}", flush=True)
    if refusal is not None:
        fail(f"K3 refuses the drafter's widths: {refusal}")
    check_fused_decode(results, gen, dev, cfg=cfg,
                       n_layers=cfg["num_hidden_layers"],
                       cases=FUSED_2B_CASES)


def check_fused_decode(results: list, gen, dev, cfg=None,
                       n_layers: int = FUSED_LAYERS,
                       cases=FUSED_CASES) -> None:
    """K3 against its plain version: 4 layers at 7B width (or `n_layers`
    at `cfg`'s widths) with the int4
    head and q sharpened by 4, C = 8704, the cache past `offset` filled
    with 1e3 (and, in the last case, NaN) so that a read past the cursor
    breaks the check.  Tolerances: FUSED_EXACT and FUSED_ROUNDED above.
    Besides summation order, the kernel rounds attention probabilities to
    bf16 against a running maximum instead of the global one; norms and
    biases are bf16 in both versions.  Each case also checks that a second
    call is bit-identical and that one call puts one kernel on the device
    (graph nodes), and prints the bytes per second beside the bound's."""
    import torch

    from mlx_vlm_tpu_torch.core.rope import make_rope
    from mlx_vlm_tpu_torch.ops import fused_decode as fd

    params, args = fused_params(n_layers, gen, dev, q_scale=4.0, cfg=cfg)
    L, C = n_layers, FUSED_CAPACITY
    D = args.hidden_size
    nkv, hd = args.num_key_value_heads, D // args.num_attention_heads
    rope = make_rope(hd, args.rope_theta, args.rope_scaling)
    h = torch.randn((1, 1, D), generator=gen).to(dev, torch.bfloat16)

    def parts(outs, cache_k, cache_v, off):
        hh, kn, vn, lg = outs
        return {"h_out": hh, "k_new[0]": kn[0], "v_new[0]": vn[0],
                "k_new[1:]": kn[1:], "v_new[1:]": vn[1:], "logits": lg,
                "k row": cache_k[:, :, :, off].float(),
                "v row": cache_v[:, :, :, off].float()}

    def untouched(cache, off, fill):
        rest = cache[:, :, :, off + 1:]
        return bool((rest.isnan() if math.isnan(fill) else rest == fill)
                    .all())

    for off, fill in cases:
        cos, sin = rope.cos_sin(torch.full((3, 1, 1), off, device=dev))
        cos, sin = cos[0, 0], sin[0, 0]
        k = torch.randn((L, 1, nkv, C, hd), generator=gen).to(
            dev, torch.bfloat16)
        v = torch.randn((L, 1, nkv, C, hd), generator=gen).to(
            dev, torch.bfloat16)
        k[:, :, :, off:] = fill
        v[:, :, :, off:] = fill
        kr, vr, kf, vf = k.clone(), v.clone(), k.clone(), v.clone()
        # the cursor is a device word, as a cache's
        word = torch.tensor(off, dtype=torch.int32, device=dev)
        out = fd.fused_decode_step(params, args, h, cos, sin, k, v, word)
        if len(out) != 4:
            fail("fused_decode: the head did not run inside the step")
        ref = fd.fused_decode_step_plain(params, args, h, cos, sin, kr, vr,
                                         off)
        floor = fd.fused_decode_step_plain(params, args, h, cos * (1 + 1e-6),
                                           sin, kf, vf, off)
        torch.cuda.synchronize()
        got, want = parts(out, k, v, off), parts(ref, kr, vr, off)
        noise = parts(floor, kf, vf, off)
        errs = {}
        ok = untouched(k, off, fill) and untouched(v, off, fill)
        for name in got:
            rel = FUSED_EXACT if name.endswith("[0]") else FUSED_ROUNDED
            scale = float(want[name].abs().max())
            err = float((got[name] - want[name]).abs().max())
            errs[name] = (err, rel * scale,
                          float((noise[name] - want[name]).abs().max()))
            ok = ok and err <= rel * scale
        step = lambda: fd.fused_decode_step(params, args, h, cos, sin, k, v,
                                            word)
        again = step()
        same = all(bool(torch.equal(x, y)) for x, y in zip(out, again))
        kernels = kernels_per_call(step)
        plan = fd.step_plan(params, args, dev)
        ok = ok and same and kernels == 1
        shape = (f"L={L} D={D} I={args.intermediate_size} "
                 f"H={args.num_attention_heads} KVH={nkv} "
                 f"V={args.vocab_size} C={C} offset={off} q_scale=4"
                 + ("" if fill == 1e3 else f" past={fill}"))
        ms = device_ms(step)
        plain_ms = device_ms(lambda: fd.fused_decode_step_plain(
            params, args, h, cos, sin, kr, vr, word), iters=5)
        call = call_ms(step)
        nbytes = fused_step_bytes(params, args, off)
        bound_ms, bound_by = bound(nbytes, fused_step_ops(params, args, off))
        print(f"  fused_decode {shape}: " + ", ".join(
            f"{n} err={e:.3e} tol={t:.3e} (plain's 1e-6 floor {f:.3e})"
            for n, (e, t, f) in errs.items())
            + f"; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (device time) "
            f"{nbytes / ms / 1e9:.3f} TB/s against the bound's "
            f"{nbytes / bound_ms / 1e9:.3f} ({bound_ms / ms:.1%}) "
            f"bound_ms={bound_ms:.5f} ({bound_by}) kernel_call_ms={call:.4f}; "
            f"kernels per call {kernels} (graph nodes), repeat bit-identical "
            f"{same}, {plan.barriers} grid barriers, {plan.chunks_at(off)} "
            f"attention chunks per kv head {'ok' if ok else 'MISMATCH'}",
            flush=True)
        results.append({"name": "fused_decode", "shape": shape,
                        "err": max(e for e, _, _ in errs.values()),
                        "tol": min(t for _, t, _ in errs.values()), "ms": ms,
                        "plain_ms": plain_ms, "call_ms": call,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, "kernels_per_call": kernels,
                        "repeat_identical": same, "ok": ok})
    if cfg is None:
        results.append(check_fused_cursor_replay(params, args, h, rope, gen,
                                                 dev))
    del params


# The cursors that one captured K3 launch is replayed at
REPLAY_OFFSETS = (300, 8545)


def check_fused_cursor_replay(params, args, h, rope, gen, dev) -> dict:
    """K3 reads its cursor from the device word when it runs: one launch
    captured in a CUDA graph (ops/_cuda.Graph) is replayed with the word
    rewritten between the replays (300, then 8545), the cache restored
    before each; each replay's outputs and written rows must be
    bit-identical to an eager call at that cursor on the same cache, and
    each replay counts one launch."""
    import torch

    from mlx_vlm_tpu_torch.ops import _cuda
    from mlx_vlm_tpu_torch.ops import fused_decode as fd

    L, C = FUSED_LAYERS, FUSED_CAPACITY
    nkv = args.num_key_value_heads
    hd = args.hidden_size // args.num_attention_heads
    base_k = torch.randn((L, 1, nkv, C, hd), generator=gen).to(
        dev, torch.bfloat16)
    base_v = torch.randn((L, 1, nkv, C, hd), generator=gen).to(
        dev, torch.bfloat16)
    k, v = base_k.clone(), base_v.clone()
    cos, sin = rope.cos_sin(torch.full((3, 1, 1), 300, device=dev))
    cos, sin = cos[0, 0].contiguous(), sin[0, 0].contiguous()
    word = torch.tensor(REPLAY_OFFSETS[0], dtype=torch.int32, device=dev)

    def call():
        return fd.fused_decode_step(params, args, h, cos, sin, k, v, word)

    def run(fn, off):
        k.copy_(base_k)
        v.copy_(base_v)
        word.fill_(off)
        # cloned: a replay's outputs are rewritten by the next replay
        outs = [t.clone() for t in fn()]
        return outs + [k[:, :, :, off].clone(), v[:, :, :, off].clone()]

    call()  # the library, the plan and the sync words exist before capture
    torch.cuda.synchronize()
    graph = _cuda.Graph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = {}
    graph.capture(lambda: outs.setdefault("captured", call()), side)
    torch.cuda.current_stream().wait_stream(side)
    before = fd.launches["fused_decode"]
    ok, notes = len(graph.tally) == 1, []
    for off in REPLAY_OFFSETS:
        replayed = run(lambda: (graph.replay(), outs["captured"])[1], off)
        eager = run(call, off)
        same = all(bool(torch.equal(a, b)) for a, b in zip(replayed, eager))
        notes.append(f"offset {off}: replay bit-identical to eager {same}")
        ok = ok and same
    counted = fd.launches["fused_decode"] - before
    ok = ok and counted == 2 * len(REPLAY_OFFSETS)  # replays + eager calls
    torch.cuda.synchronize()
    del graph
    print(f"  fused_decode cursor word: one captured launch replayed at "
          f"{', '.join(notes)}; launches counted {counted} (want "
          f"{2 * len(REPLAY_OFFSETS)}: one per replay and eager call) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    return {"name": "fused_decode", "shape": "cursor replay", "err": 0.0,
            "tol": 0.0, "ms": None, "plain_ms": None, "call_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
            "kernels_per_call": 1, "repeat_identical": ok, "ok": ok}


KV_HEADS, KV_ROWS, KV_DIM, KV_CAPACITY = 4, 7, 128, 8704
KV_DIMS = (KV_HEADS, KV_ROWS, KV_DIM, KV_CAPACITY)
# PaliGemma-3B's decode step at kv_bits 4 ((p3)): 8 query heads over one
# KV head of 256 (BH = 1), the same capacity; K6's cases there: offsets
# 1, 300 and 8545, left_pad 100, and NaN past the cursor at 8545
K6_PALIGEMMA_DIMS = (1, 8, 256, 8704)
K6_PALIGEMMA_CASES = ((1, 0), (300, 0), (8545, 0), (8545, 100))
# (offsets, left_pad) cases; the last has per-row cursors
KV_CASES = ((1, 0), (300, 0), (8545, 0), (8545, 100),
            ((8545, 300, 4000, 1), (0, 0, 100, 0)))
KV_TOL = 1e-2
# K8's kv_bits: 3.5 (64 dims at 3 bits + 64 at 4, requests (e)) at every
# KV_CASES entry; 3.05 (120 + 8) and 3.95 (8 + 120), whose 8-dim segments
# pad their k-steps, at offset 8545
K8_CASES = ((3.5, KV_CASES), (3.05, ((8545, 0),)), (3.95, ((8545, 0),)))


def _kv_case(off, lp, dev, dims=None):
    """Cursor tensors [BH] and a shape label for one KV_CASES entry, at
    `dims` (BH, g, D, C; KV_HEADS, KV_ROWS, KV_DIM, KV_CAPACITY when
    None)."""
    import torch

    BH, G, D, C = dims or KV_DIMS
    offs = off if isinstance(off, tuple) else (off,) * BH
    lps = lp if isinstance(lp, tuple) else (lp,) * BH
    t = [torch.tensor(x, dtype=torch.int32, device=dev) for x in (offs, lps)]
    return t[0], t[1], (f"BH={BH} g={G} D={D} C={C} offset={off} "
                        f"left_pad={lp} q_scale=4")


def kv_work(offs, lps, token_bytes: int, head_bytes: int,
            dims=None) -> tuple:
    """(bytes, operations) of a K6/K7/K8 call on this data: `token_bytes`
    of codes and scales per visible token and KV head, `head_bytes` per
    head for the query, cursors and output; 4 * g * D operations per
    visible token (the score dot and the value sum)."""
    BH, G, D, _ = dims or KV_DIMS
    visible = float((offs - lps).clamp(min=0).sum())
    return (visible * token_bytes + BH * head_bytes, 4.0 * G * D * visible)


def split_dims(kv_bits: float, D: int) -> tuple:
    """(lo bits, hi bits, DA, DB) of the split cache at kv_bits
    (core/turboquant.py's init_turboquant_split_cache rule)."""
    lo, hi = int(math.floor(kv_bits)), int(math.ceil(kv_bits))
    d_hi = max(8, min(D - 8, int(round((kv_bits - lo) * D / 8)) * 8))
    return lo, hi, D - d_hi, d_hi


def check_kv_case(results: list, run, arrays, nbytes: float, plan) -> None:
    """K6's, K7's or K8's further checks of the case _check just recorded:
    the kernels one call puts on the device (one), a bit-identical repeat,
    and a cold time: `graph_ms` over `cold_copies` of the codes, scales and
    query (`run(*arrays)` is the call), as a decode step reads each layer's
    cache cold; the warm time is device_ms's.  Prints the bytes per second
    beside the bound's."""
    import functools

    import torch

    r = results[-1]
    out = run(*arrays)
    kernels = kernels_per_call(lambda: run(*arrays))
    same = bool(torch.equal(run(*arrays), out))
    size = sum(a.numel() * a.element_size() for a in arrays)
    copies = [arrays] + [tuple(a.clone() for a in arrays)
                         for _ in range(cold_copies(size) - 1)]
    r["warm_ms"], r["ms"] = r["ms"], graph_ms(
        [functools.partial(run, *c) for c in copies], iters=5)
    del copies
    r["kernels_per_call"], r["repeat_identical"] = kernels, same
    r["plan"] = (f"T={plan.tokens} splits={plan.splits} warps={plan.warps} "
                 f"n_tiles={plan.n_tiles} smem={plan.smem_bytes}")
    r["ok"] = r["ok"] and same and kernels == 1
    print(f"  {r['name']} {r['shape']}: plan {r['plan']}; kernel_ms="
          f"{r['ms']:.4f} cold {r['warm_ms']:.4f} warm (device time), "
          f"{nbytes / r['ms'] / 1e9:.4f} TB/s cold against the bound's "
          f"{nbytes / r['bound_ms'] / 1e9:.3f} ({r['bound_ms'] / r['ms']:.1%});"
          f" kernels per call {kernels} (graph nodes), repeat bit-identical "
          f"{same} {'ok' if r['ok'] else 'MISMATCH'}", flush=True)


def kv_codes(width: int, gen, dev, dims=None):
    """Random code bytes [BH, C, width] on the card (KV_DIMS unless
    `dims`)."""
    import torch

    BH, _, _, C = dims or KV_DIMS
    return torch.randint(0, 256, (BH, C, width), generator=gen,
                         dtype=torch.uint8).to(dev)


def kv_scales(off, lo: float, hi: float, gen, dev, dims=None):
    """Per-token f32 scales [BH, C] uniform in [lo, hi), and 1e3 from each
    row's cursor on (a read past the cursor shows)."""
    import torch

    BH, _, _, C = dims or KV_DIMS
    x = lo + (hi - lo) * torch.rand((BH, C), generator=gen)
    col = torch.arange(C)[None]
    return torch.where(col >= off.cpu()[:, None].long(),
                       torch.full_like(x, 1e3), x).to(dev)


def k6_inputs(off, gen, dev, dims=None) -> tuple:
    """K6's inputs at BH x g x D over C (KV_DIMS unless `dims`): int8
    query codes of q x 4 with their (sum, qs), random 4-bit codes, and
    per-token scales and biases that are 1e3 from each row's cursor on."""
    import torch

    BH, G, D, _ = dims or KV_DIMS
    q = torch.randn((BH, G, D), generator=gen) * 4
    qs = q.abs().amax(-1) / 127.0
    q8 = torch.round(q / qs[..., None])
    meta = torch.stack([q8.sum(-1), qs], -1).to(dev)
    q8 = q8.to(torch.int8).to(dev)
    k4, v4 = (kv_codes(D // 2, gen, dev, dims) for _ in range(2))
    ks, vs = (kv_scales(off, 0.02, 0.3, gen, dev, dims) for _ in range(2))
    kb, vb = (kv_scales(off, -2.0, 0.0, gen, dev, dims) for _ in range(2))
    return q8, meta, k4, ks, kb, v4, vs, vb


def k6_work(off, lp, dims=None) -> tuple:
    """(bytes, operations) of a K6 call: D + 16 bytes of codes and scales
    per visible token; the query codes, their (sum, qs), the cursors and
    the f32 output per head."""
    _, G, D, _ = dims or KV_DIMS
    return kv_work(off, lp, D + 16, G * D + 8 * G + G * D * 4 + 8, dims)


def time_k6(dev, cases=KV_CASES) -> None:
    """Cold (graph_ms over cold_copies of the inputs) and warm (device_ms)
    times of K6's wrapper at `cases` (KV_CASES entries), one printed line a
    case.  It calls only `int4_kv_decode_attention`, so it times the K6 of
    whichever tree the package is imported from: run from an unpacked
    parent, it puts the parent's times beside this tree's in one call."""
    import functools

    import torch

    from mlx_vlm_tpu_torch.ops import int4_kv_attention as k6

    gen = torch.Generator().manual_seed(SEED + 6)
    scale = KV_DIM ** -0.5
    for off_v, lp_v in cases:
        off, lp, shape = _kv_case(off_v, lp_v, dev)
        a6 = k6_inputs(off, gen, dev)

        def run(*arrays, off=off, lp=lp):
            return k6.int4_kv_decode_attention(*arrays, off, scale,
                                               left_pad=lp)

        size = sum(a.numel() * a.element_size() for a in a6)
        copies = [a6] + [tuple(a.clone() for a in a6)
                         for _ in range(cold_copies(size) - 1)]
        cold = graph_ms([functools.partial(run, *c) for c in copies], iters=5)
        del copies
        warm = device_ms(lambda: run(*a6))
        bound_ms, bound_by = bound(*k6_work(off, lp))
        print(f"  time_k6 int4_kv_attention {shape}: kernel_ms={cold:.4f} "
              f"cold {warm:.4f} warm bound_ms={bound_ms:.5f} ({bound_by})",
              flush=True)


def check_k6_case(results: list, gen, dev, off_v, lp_v, dims, sms) -> None:
    """K6 against its plain version at one (offset, left_pad) case of
    `dims` (BH, g, D, C), then check_kv_case's further checks; at offset
    8545 with left_pad 0 also the same inputs with NaN scales and biases
    past the cursor, held to the plain version on the 1e3 inputs and to
    the kernel's own output there, bit for bit."""
    import torch

    from mlx_vlm_tpu_torch.ops import int4_kv_attention as k6

    BH, G, D, C = dims
    scale = D ** -0.5
    plan = k6.int4_kv_attention_plan(BH, G, C, D, sms)
    off, lp, shape = _kv_case(off_v, lp_v, dev, dims)
    a6 = k6_inputs(off, gen, dev, dims)

    def run(*arrays):
        return k6.int4_kv_decode_attention(*arrays, off, scale, left_pad=lp)

    def case(label, arrays):
        def plain():
            return k6.int4_kv_decode_attention_plain(*a6, off, scale, lp)

        out = run(*arrays)
        _check(results, "int4_kv_attention", label, out, plain(), KV_TOL,
               lambda: run(*arrays), plain, floor=0.0,
               work=k6_work(off, lp, dims))
        check_kv_case(results, run, arrays, k6_work(off, lp, dims)[0], plan)
        return out

    case(shape, a6)
    if (off_v, lp_v) == (8545, 0):
        nan6 = tuple(a.clone() for a in a6)
        col = torch.arange(C, device=dev)[None]
        for a in nan6[3:5] + nan6[6:8]:
            a[col >= off[:, None]] = float("nan")
        got = case(shape + " past=nan", nan6)
        same = bool(torch.equal(got, run(*a6)))
        r = results[-1]
        r["ok"] = r["ok"] and same
        print(f"  int4_kv_attention {r['shape']}: bit-identical to the 1e3 "
              f"case {same} {'ok' if r['ok'] else 'MISMATCH'}", flush=True)


def check_k6_paligemma(results: list, gen, dev) -> None:
    """K6 at PaliGemma-3B's decode step ((p3): BH = 1, g = 8, D = 256,
    C = 8704) at K6_PALIGEMMA_CASES, as check_kv_kernels holds it at
    4 x 7 x 128: the plan cuts the capacity into short splits there, whose
    combine this holds."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for off_v, lp_v in K6_PALIGEMMA_CASES:
        check_k6_case(results, gen, dev, off_v, lp_v, K6_PALIGEMMA_DIMS, sms)


def check_kv_kernels(results: list, gen, dev) -> None:
    """K6, K7 (3-bit keys, 4-bit values) and K8 (K8_CASES) against their
    plain versions at the shapes of requests (d)-(f): 4 KV heads of 7
    query rows, C = 8704, q x 4.  The codes past each cursor are random and
    their scales 1e3, so that a read past the cursor breaks the check; K6
    also runs at offset 8545 with NaN scales and biases past the cursor,
    held to its plain version on the same inputs with 1e3 there (the plain
    version multiplies the masked p = 0 by them) and to its own output
    there, bit for bit.  Tolerance KV_TOL * max|ref|: the kernels round
    p * vs to bf16 against split-local softmax maxima.  Each case also
    records its plan, kernels per call, a bit-identical repeat and a cold
    time (check_kv_case)."""
    import torch

    from mlx_vlm_tpu_torch.core.turboquant import _levels
    from mlx_vlm_tpu_torch.ops import tq_kv_attention as tk

    BH, G, D, C = KV_DIMS
    scale = D ** -0.5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def codes(width):
        return kv_codes(width, gen, dev)

    def scales(off, lo, hi):
        return kv_scales(off, lo, hi, gen, dev)

    luts = (_levels(3), _levels(4))
    head_out = G * D * 4 + 8  # output f32, offset and left_pad
    queries = {}
    for off_v, lp_v in KV_CASES:
        off, lp, shape = _kv_case(off_v, lp_v, dev)
        check_k6_case(results, gen, dev, off_v, lp_v, KV_DIMS, sms)
        qr = queries[(off_v, lp_v)] = (
            torch.randn((BH, G, D), generator=gen) * 4).to(dev)
        a7 = (codes(D * 3 // 8), scales(off, 0.5, 1.5), codes(D // 2),
              scales(off, 0.5, 1.5))

        def k7(*arrays, off=off, lp=lp, qr=qr):
            return tk.tq_kv_decode_attention(qr, *arrays, off, scale, 3, 4,
                                             *luts, left_pad=lp)

        def p7(off=off, lp=lp, qr=qr, a7=a7):
            return tk.tq_kv_decode_attention_plain(qr, *a7, off, scale, 3, 4,
                                                   *luts, lp)

        work = kv_work(off, lp, D * 7 // 8 + 8, G * D * 4 + head_out)
        _check(results, "tq_kv_attention", shape, k7(*a7), p7(), KV_TOL,
               lambda: k7(*a7), p7, floor=0.0, work=work)
        check_kv_case(results, k7, a7, work[0], tk.tq_kv_attention_plan(
            BH, G, C, [(D, 3, 4)], sms))
    for kv_bits, cases in K8_CASES:
        lo, hi, DA, DB = split_dims(kv_bits, D)
        for off_v, lp_v in cases:
            off, lp, shape = _kv_case(off_v, lp_v, dev)
            if kv_bits != 3.5:
                shape += f" kv_bits={kv_bits}"
            qr = queries[(off_v, lp_v)]
            a8 = (codes(DA * lo // 8), scales(off, 0.5, 1.5),
                  codes(DB * hi // 8), scales(off, 0.5, 1.5),
                  codes(DA * lo // 8), scales(off, 0.5, 1.5),
                  codes(DB * hi // 8), scales(off, 0.5, 1.5))

            def k8(*arrays, off=off, lp=lp, qr=qr, lo=lo, hi=hi):
                return tk.tq_kv_decode_attention_split(
                    qr, *arrays, off, scale, lo, hi, _levels(lo),
                    _levels(hi), left_pad=lp)

            def p8(off=off, lp=lp, qr=qr, a8=a8, lo=lo, hi=hi):
                return tk.tq_kv_decode_attention_split_plain(
                    qr, *a8, off, scale, lo, hi, _levels(lo), _levels(hi),
                    lp)

            token = (DA * lo // 8 + DB * hi // 8) * 2 + 16
            work = kv_work(off, lp, token, G * D * 4 + head_out)
            _check(results, "tq_kv_attention_split", shape, k8(*a8), p8(),
                   KV_TOL, lambda: k8(*a8), p8, floor=0.0, work=work)
            check_kv_case(results, k8, a8, work[0], tk.tq_kv_attention_plan(
                BH, G, C, [(DA, lo, lo), (DB, hi, hi)], sms))


# ------------------------------------------------------------ phase 3


def _processor(name_ids: bool = False, model=None):
    """`model`'s processor (utils/processing.py `processor_for`: LLaVA's
    CLIP processor, which expands each <image> into 576 tokens, else the
    Qwen2-VL processor with `model`'s image processor, patch 16 for
    Qwen3-VL and 14 otherwise) over utils/testing.py's ByteTokenizer with
    the family's special tokens (Llama-3.1's, LLaVA-1.5's, Gemma's and
    PaliGemma's, Mixtral's, OLMoE's, Phi-3.5-MoE's, Granite 3.0's, gpt-oss's
    and phi-2's ids,
    else Qwen2-VL's; PaliGemma's processor writes its prompt as
    transformers' does); with `name_ids`, its decode writes every id as
    "<id>", so
    that a text shows each token that random weights generate (most ids
    are not bytes)."""
    from mlx_vlm_tpu_torch.utils.processing import processor_for
    from mlx_vlm_tpu_torch.utils.testing import (CLASSIC_SPECIAL_TOKENS,
                                                 LLAMA3_SPECIAL_TOKENS,
                                                 LLAVA_SPECIAL_TOKENS,
                                                 MOE_TEXT_SPECIAL_TOKENS,
                                                 PALIGEMMA_SPECIAL_TOKENS,
                                                 ByteTokenizer)

    class NamingTokenizer(ByteTokenizer):
        def decode(self, ids, skip_special_tokens: bool = False) -> str:
            return "".join(f"<{i}>" for i in np.asarray(ids).reshape(-1))

    kind = getattr(getattr(model, "config", None), "model_type", "")
    gemma = (PALIGEMMA_SPECIAL_TOKENS, "<eos>", "<pad>")
    specials = {"llama": (LLAMA3_SPECIAL_TOKENS, "<|eot_id|>",
                          "<|end_of_text|>"),
                "llava": (LLAVA_SPECIAL_TOKENS, "</s>", "<pad>"),
                "paligemma": gemma, "gemma": gemma, "gemma2": gemma,
                **MOE_TEXT_SPECIAL_TOKENS,
                **CLASSIC_SPECIAL_TOKENS}.get(kind, ())
    tok = (NamingTokenizer if name_ids else ByteTokenizer)(*specials)
    return processor_for(tok, model)


def _image(size: int) -> np.ndarray:
    return np.random.default_rng(SEED + size).integers(
        0, 256, (size, size, 3), dtype=np.uint8)


def _clip(n_frames: int, size: int) -> np.ndarray:
    """A seeded clip of `n_frames` uint8 size x size frames
    (utils/testing.py `synthetic_video`)."""
    from mlx_vlm_tpu_torch.utils.testing import synthetic_video

    return synthetic_video(n_frames, size, seed=SEED + 11 + n_frames)


VIDEO_TRIPLE = "<|vision_start|><|video_pad|><|vision_end|>"
# the frames' rate: transformers' Qwen2.5-VL default, so one frame group
# spans 1 s (Qwen2.5-VL's times step by tokens_per_second = 2 a group)
VIDEO_FPS = 2.0


def video_prompt(proc, cfg, text: str, frames, with_image: bool) -> str:
    """The chat prompt of a clip: apply_chat_template's video message, or
    with an image an image message whose text opens with the video's
    start / pad / end triple (the image's tokens first)."""
    from mlx_vlm_tpu_torch import apply_chat_template

    if with_image:
        return apply_chat_template(proc, cfg, VIDEO_TRIPLE + text,
                                   num_images=1)
    return apply_chat_template(proc, cfg, text, video=frames, fps=VIDEO_FPS,
                               num_images=0)


def video_inputs(proc, cfg, text: str, frames, image=None) -> dict:
    """prepare_inputs' arrays of a clip (and an image before it)."""
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    return prepare_inputs(proc, video_prompt(proc, cfg, text, frames,
                                             image is not None),
                          images=image, videos=frames, fps=VIDEO_FPS)


def phase3_clip(proc) -> np.ndarray:
    """Phase 3's clip: 4 frames of 112 x 112 (two frame groups of 8 x 8
    patches at patch 14), so that the CPU references take seconds; at
    Qwen3-VL's patch 16, 128 x 128, the nearest size that its processor
    takes without a resize (a multiple of 32)."""
    ip = proc.image_processor
    factor = ip.patch_size * ip.merge_size
    return _clip(4, factor * math.ceil(112 / factor))


def counters() -> list:
    """Every kernel's launch counter (dicts of name -> count)."""
    from mlx_vlm_tpu_torch.ops import flash_attention as fa
    from mlx_vlm_tpu_torch.ops import fused_decode as fd
    from mlx_vlm_tpu_torch.ops import int4_kv_attention as k6
    from mlx_vlm_tpu_torch.ops import int4_matvec as iv
    from mlx_vlm_tpu_torch.ops import qmatmul as k5
    from mlx_vlm_tpu_torch.ops import tq_kv_attention as tk

    return [iv.launches, fa.launches, fd.launches, k5.launches, k6.launches,
            tk.launches]


def reset_counts() -> None:
    """Every kernel's launch counter to 0, and core/moe.py's tallies of its
    prefill route (calls, experts run), which `moe_want` reads."""
    from mlx_vlm_tpu_torch.core import moe

    for c in counters() + [moe.stats]:
        for k in c:
            c[k] = 0


def moe_want(counts: dict, n_layers: int, forwards: int) -> dict:
    """Launches of the expert layers of a Qwen3-VL-MoE run of `forwards`
    forward passes (prefill chunks and decode steps) through `n_layers`
    layers, each layer call on the decode route (one expert-indexed launch
    per projection) or on the prefill route (core/moe.py `stats`: one K5
    call per projection and expert that had rows); every other counter 0
    (the caller adds what its mode runs beside)."""
    from mlx_vlm_tpu_torch.core import moe

    want = {k: 0 for k in counts}
    want["qmatmul_experts"] = 3 * (n_layers * forwards
                                   - moe.stats["grouped_calls"])
    want["qmatmul_int4"] = 3 * moe.stats["grouped_experts"]
    return want


def batch_moe_want(n_layers: int):
    """want(counts, generator stats) of a batch of an MoE model (the
    default mode): `moe_want` over its prefill chunks and batch steps."""
    return lambda counts, st: moe_want(counts, n_layers,
                                       st["prefill_chunks"] + st["steps"])


def read_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


class env_vars:
    """Set environment variables (a value of None unsets one) for the
    duration of a with block."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.old = {k: os.environ.pop(k, None) for k in self.values}
        for k, v in self.values.items():
            if v is not None:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


class fold_once:
    """utils/loader.py's `_fold_triple` memoized for the duration of a with
    block, so that an mlx triple folds once in a runtime mode, whichever
    loads and checkpoints hold it: the CPU references' and the card's
    loads of one checkpoint, and checkpoints that share arrays (phase 3's
    2- and 3-layer slices and phase 4's Qwen2.5-VL-7B hold the arrays of
    the full-depth checkpoints, `family_checkpoints`).  Every fold runs on
    the card (w8chan's per-channel requantization in float64 there;
    w4grp's relayout on the host), whatever the load's device: a CPU
    reference's load takes a host copy of the card's result, which is the
    host fold's byte for byte (`check_fold_on_card`).  A triple is known by
    the identity of its arrays, held by the memo so that no identity is
    reused."""

    def __enter__(self):
        from mlx_vlm_tpu_torch.utils import loader

        self.loader, self.real, self.memo = loader, loader._fold_triple, {}
        # the per-channel folds on the card: (count, seconds); they run on
        # the loading thread (w4grp's relayouts on the loader's pool)
        self.card = [0, 0.0]

        def fold(w, scales, biases, bits, group_size, mode, is_embed,
                 device=None):
            import torch

            key = (id(w), id(scales), id(biases), bits, group_size, mode,
                   is_embed)
            if key not in self.memo:
                tic = time.perf_counter()
                out = self.real(w, scales, biases, bits, group_size, mode,
                                is_embed, device="cuda")
                if type(out).__name__ == "ChannelQuantizedTensor":
                    torch.cuda.synchronize()
                    self.card[0] += 1
                    self.card[1] += time.perf_counter() - tic
                self.memo[key] = (out, (w, scales, biases))
            return self.memo[key][0]

        loader._fold_triple = fold
        return self

    def __exit__(self, *exc):
        self.loader._fold_triple = self.real
        self.memo.clear()


def check_fold_on_card(ckpt: tuple) -> None:
    """The w8chan fold of one vocab-sized table (Llama-3.1-8B's embedding,
    128256 x 4096 at 4 bits) on the host (torch float64 on the CPU) and on
    the card: codes, scales and biases byte for byte equal; both times
    printed."""
    import torch

    from mlx_vlm_tpu_torch.core.quant import (from_mlx_packed,
                                              to_channel_quantized)

    cfg, w = ckpt
    b = "model.embed_tokens."
    t = from_mlx_packed(w[b + "weight"], w[b + "scales"], w[b + "biases"],
                        4, cfg["quantization"]["group_size"])
    tic = time.perf_counter()
    host = to_channel_quantized(t, device="cpu")
    host_s = time.perf_counter() - tic
    torch.cuda.synchronize()
    tic = time.perf_counter()
    card = to_channel_quantized(t, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - tic
    differ = {f: int((getattr(host, f).view(torch.int8 if f == "q8"
                                             else torch.int16)
                      != getattr(card, f).cpu().view(
                          torch.int8 if f == "q8" else torch.int16)).sum())
              for f in ("q8", "scales", "biases")}
    same = not any(differ.values())
    print(f"  w8chan fold of a {t.q.shape[0]} x {t.q.shape[1] * 2} table: "
          f"host (torch float64, {torch.get_num_threads()} threads) "
          f"{host_s:.2f} s, card {card_s:.3f} s; codes, scales and biases "
          f"byte-equal {same} (elements that differ: {differ})", flush=True)
    if not same:
        fail("the w8chan fold on the card differs from the host's")


# Qwen3-VL-30B-A3B's decoder layers in phase 4: its published 48 cut to
# 12 when the llama family came, then to 6 when video came (the run took
# 1045.9 s of its 1200 s limit at 12), so that it stays near 950 s;
# phase 3 holds 2 of them to the CPU.  They are the first layers of
# Qwen3-30B-A3B's build, whose text widths are the same
MOE_LAYERS = 6
# Qwen3-30B-A3B's decoder layers in phase 4 ((x1)-(x5)), of its published
# 48, and Mixtral-8x7B's ((y1)), of its published 32, cut for the run's
# time: the whole run took 1174.1 s at 24 and 4 layers (phase 3 759.1 s;
# one NVIDIA H100 80GB HBM3 at 700 W) on a host 1.22-1.26 times slower
# than the one that ran 792.2 s before these models came; Qwen3-30B-A3B
# at 8 since PaliGemma's parts came (a run with them projected past 1,050
# s at 12)
QWEN3_MOE_LAYERS = 8
MIXTRAL_LAYERS = 2
# the text MoE checkpoints that phase 3 alone takes, built at its depth:
# name -> (utils/testing's published config, decoder layers, seed)
MOE_TEXT_PHASE3 = {
    "qwen1_5_moe_a2_7b": ("qwen1_5_moe_a2_7b_config", 1, SEED + 13),
    "olmoe_1b_7b": ("olmoe_1b_7b_config", 2, SEED + 14),
    "phi_3_5_moe": ("phi_3_5_moe_config", 1, SEED + 15),
    "granite_3_0_3b_a800m": ("granite_3_0_3b_a800m_config", 2, SEED + 16),
}


# gpt-oss-20b's decoder layers in phase 4 ((o1)-(o3)), of its published
# 24: two sliding and two full, its widths whole; phase 3 holds its first
# 2 (one of each) to the CPU
GPT_OSS_LAYERS = 4


def qwen3_vl_moe_from_text(text: tuple, vision: tuple) -> tuple:
    """Qwen3-VL-30B-A3B's checkpoint at MOE_LAYERS decoder layers from
    Qwen3-30B-A3B's (`text`: the same language-model widths, so the same
    arrays: its embedding, final norm, head and first MOE_LAYERS layers
    under Qwen3-VL's names, its 8-bit routers' per-path entries under the
    conversion's) and Qwen3-VL-30B-A3B's vision tower (`vision`)."""
    tcfg, tw = text
    cfg, w = vision
    cfg = json.loads(json.dumps(cfg))
    cfg["text_config"]["num_hidden_layers"] = MOE_LAYERS
    q = {k: v for k, v in tcfg["quantization"].items()
         if not isinstance(v, dict)}
    for k, v in tw.items():
        if k.startswith("model.layers."):
            i = int(k.split(".")[2])
            if i >= MOE_LAYERS:
                continue
            path = k[:k.rindex(".")]
            if path in tcfg["quantization"]:
                q["language_model." + path] = tcfg["quantization"][path]
        w[k.replace("model.", "model.language_model.", 1)
          if k.startswith("model.") else k] = v
    cfg["quantization"] = q
    return cfg, w


def family_checkpoints() -> dict:
    """The random mlx checkpoints of phases 3 and 4 at the published
    widths, built once, each on a thread of its own (the draws release the
    interpreter lock, and each checkpoint has its own seed, so the arrays
    are those of a sequential build): "qwen2_vl_7b" (4 bits, seed
    SEED + 2), "qwen2_5_vl_7b" (Qwen2.5-VL-7B: the same language-model
    arrays, whose widths are Qwen2-VL-7B's, and its own windowed vision
    tower, seed SEED + 6), "qwen3_vl_8b" (seed SEED + 7),
    "qwen3_30b_a3b" (Qwen3-30B-A3B at QWEN3_MOE_LAYERS decoder layers, its
    128 experts a layer in the mlx fused layout and its routers at 8 bits
    under per-path entries, seed SEED + 8), "qwen3_vl_moe_30b_a3b"
    (Qwen3-VL-30B-A3B: its first MOE_LAYERS layers with its embedding and
    head, and Qwen3-VL's deepstack tower, seed SEED + 8,
    `qwen3_vl_moe_from_text`), "llama_3_1_8b" (seed SEED + 9),
    "llava_1_5_7b" (seed SEED + 10), "mixtral_8x7b" (MIXTRAL_LAYERS
    layers, 8-bit routers, seed SEED + 12), MOE_TEXT_PHASE3's (8-bit
    routers), "gpt_oss_20b" (gpt-oss-20b at GPT_OSS_LAYERS decoder layers,
    its expert stacks in the mlx layout, seed SEED + 19), "phi_2" (phi-2 at
    its 32 layers, seed SEED + 20), "paligemma2_3b" (seed SEED + 17) and
    "paligemma_3b" (seed SEED + 18) with their text models as
    text-only checkpoints "gemma2_2b" and "gemma_2b" (the same arrays,
    `gemma_text_of`), and "qwen2_vl_7b_8bit" (Qwen2-VL-7B at 8 bits,
    request (h)'s, seed SEED + 3).  Each is (config, weights)."""
    from concurrent.futures import ThreadPoolExecutor

    from mlx_vlm_tpu_torch.utils import testing
    from mlx_vlm_tpu_torch.utils.testing import (gpt_oss_20b_config,
                                                 is_vision_key,
                                                 llama_3_1_8b_config,
                                                 llava_1_5_7b_config,
                                                 mixtral_8x7b_config,
                                                 mlx_int4_checkpoint,
                                                 mlx_quantized_checkpoint,
                                                 paligemma2_3b_224_config,
                                                 paligemma_3b_224_config,
                                                 phi_2_config,
                                                 qwen2_5_vl_7b_config,
                                                 qwen2_vl_7b_config,
                                                 qwen3_30b_a3b_config,
                                                 qwen3_vl_8b_config,
                                                 qwen3_vl_moe_30b_a3b_config)

    def at_depth(cfg: dict, n_layers: int) -> dict:
        cfg["num_hidden_layers"] = n_layers
        if "layer_types" in cfg:
            cfg["layer_types"] = cfg["layer_types"][:n_layers]
        return cfg

    builds = {
        "qwen2_vl_7b": lambda: mlx_int4_checkpoint(qwen2_vl_7b_config(),
                                                   seed=SEED + 2),
        "qwen2_5_vl_vision": lambda: mlx_quantized_checkpoint(
            qwen2_5_vl_7b_config(), seed=SEED + 6, vision_only=True),
        "qwen3_vl_8b": lambda: mlx_int4_checkpoint(qwen3_vl_8b_config(),
                                                   seed=SEED + 7),
        "qwen3_30b_a3b": lambda: mlx_quantized_checkpoint(
            at_depth(qwen3_30b_a3b_config(), QWEN3_MOE_LAYERS),
            seed=SEED + 8, router_bits=8),
        "qwen3_vl_moe_vision": lambda: mlx_quantized_checkpoint(
            qwen3_vl_moe_30b_a3b_config(), seed=SEED + 8, vision_only=True),
        "llama_3_1_8b": lambda: mlx_int4_checkpoint(llama_3_1_8b_config(),
                                                    seed=SEED + 9),
        "llava_1_5_7b": lambda: mlx_int4_checkpoint(llava_1_5_7b_config(),
                                                    seed=SEED + 10),
        "mixtral_8x7b": lambda: mlx_quantized_checkpoint(
            at_depth(mixtral_8x7b_config(), MIXTRAL_LAYERS), seed=SEED + 12,
            router_bits=8),
        "qwen2_vl_7b_8bit": lambda: mlx_quantized_checkpoint(
            qwen2_vl_7b_config(), bits=8, seed=SEED + 3),
        "paligemma2_3b": lambda: mlx_int4_checkpoint(
            paligemma2_3b_224_config(), seed=SEED + 17),
        "paligemma_3b": lambda: mlx_int4_checkpoint(
            paligemma_3b_224_config(), seed=SEED + 18),
        "gpt_oss_20b": lambda: mlx_int4_checkpoint(
            at_depth(gpt_oss_20b_config(), GPT_OSS_LAYERS), seed=SEED + 19),
        "phi_2": lambda: mlx_int4_checkpoint(phi_2_config(), seed=SEED + 20),
    }
    for name, (config, n_layers, seed) in MOE_TEXT_PHASE3.items():
        builds[name] = (lambda c=config, n=n_layers, sd=seed:
                        mlx_quantized_checkpoint(
                            at_depth(getattr(testing, c)(), n), seed=sd,
                            router_bits=8))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {k: pool.submit(build) for k, build in builds.items()}
        out = {k: f.result() for k, f in futures.items()}
    cfg25, vision = out.pop("qwen2_5_vl_vision")
    lm = {k: v for k, v in out["qwen2_vl_7b"][1].items()
          if not is_vision_key(k)}
    out["qwen2_5_vl_7b"] = (cfg25, {**lm, **vision})
    out["qwen3_vl_moe_30b_a3b"] = qwen3_vl_moe_from_text(
        out["qwen3_30b_a3b"], out.pop("qwen3_vl_moe_vision"))
    # Qwen1.5-MoE's embedding and head have Qwen3-30B-A3B's shapes: the
    # same arrays, so that `fold_once` requantizes them once
    q15, q3 = out["qwen1_5_moe_a2_7b"][1], out["qwen3_30b_a3b"][1]
    for k in [k for k in q15 if k.startswith(("model.embed_tokens.",
                                              "lm_head."))]:
        q15[k] = q3[k]
    out["gemma2_2b"] = gemma_text_of(out["paligemma2_3b"])
    out["gemma_2b"] = gemma_text_of(out["paligemma_3b"])
    print(f"  checkpoints (Qwen2-VL-7B, Qwen2.5-VL-7B's vision tower, "
          f"Qwen3-VL-8B, Qwen3-30B-A3B at {QWEN3_MOE_LAYERS} layers with "
          f"Qwen3-VL-30B-A3B's tower, Llama-3.1-8B, LLaVA-1.5-7B, "
          f"Mixtral-8x7B at {MIXTRAL_LAYERS} layers, "
          f"{', '.join(MOE_TEXT_PHASE3)}, PaliGemma2-3B, PaliGemma-3B, "
          f"gpt-oss-20b at {GPT_OSS_LAYERS} layers, phi-2, "
          f"Qwen2-VL-7B at 8 bits) built in "
          f"{time.perf_counter() - t0:.1f} s on {len(builds)} threads",
          flush=True)
    return out


def gemma_text_of(ckpt: tuple) -> tuple:
    """A PaliGemma checkpoint's text model as a text-only gemma / gemma2
    checkpoint: its text config (vocab as the checkpoint has it) with the
    quantization entry, and its `language_model.` arrays under their own
    names (the same arrays, so `fold_once` folds them once for both)."""
    cfg, w = ckpt
    text = dict(cfg["text_config"], quantization=cfg["quantization"])
    return text, {k[len("language_model."):]: v for k, v in w.items()
                  if k.startswith("language_model.")}


def sliced(ckpt: tuple, n_layers: int) -> tuple:
    """A checkpoint cut to its first `n_layers` decoder layers (a vision
    tower's layers kept): the same arrays (so `fold_once` folds them once
    for both)."""
    import re

    cfg, w = ckpt
    pat = re.compile(r"(?:^|\.)(?:model|language_model)\.layers\.(\d+)\.")
    keep = {k: v for k, v in w.items()
            if (m := pat.search(k)) is None or int(m.group(1)) < n_layers}
    cfg = json.loads(json.dumps(cfg))
    if "text_config" in cfg:
        cfg["text_config"]["num_hidden_layers"] = n_layers
    else:
        cfg["num_hidden_layers"] = n_layers
    return cfg, keep


def teacher_forced_logits(model, inputs: dict, forced=None,
                          n_steps: int = 8, kv_bits=None) -> tuple:
    """Per-step last-token logits [n_steps, V] (f32 numpy): the prompt in one
    prefill chunk, then n_steps - 1 decode steps (the fused route when it is
    on and the cache is bf16) fed `forced` tokens, or the greedy argmax when
    `forced` is None.  `kv_bits` picks the cache as generate does."""
    return forced_steps(model, *prefill_unpadded(model, inputs, n_steps,
                                                 kv_bits), forced, n_steps)


def prefill_unpadded(model, inputs: dict, n_steps: int, kv_bits) -> tuple:
    """The prompt in one unpadded prefill chunk into a one-row cache with
    room for n_steps more: (the cache, the prefill's logits [V], the rope
    delta)."""
    import torch

    from mlx_vlm_tpu_torch.generate.ar import make_cache
    from mlx_vlm_tpu_torch.generate.common import embed_prompt

    dev = model.device
    lm = model.language_model
    lp = model.params["language_model"]
    embeds, pos, deltas = embed_prompt(model, inputs)
    S = embeds.shape[1]
    cache = make_cache(model, 1, 256 * ((S + n_steps + 255) // 256),
                       embeds.dtype, kv_bits, device=dev)
    h = lm(lp, embeds, cache, torch.from_numpy(pos.astype(np.int64)).to(dev))
    first = lm.logits(lp, h[:, -1:])[0, 0].float().cpu().numpy()
    return cache, first, int(deltas[0, 0])


def forced_steps(model, cache, first: np.ndarray, delta: int, forced,
                 n_steps: int) -> tuple:
    """`first` (the prefill's logits [V]), then n_steps - 1 decode steps of
    one row on `cache` (its cursor at the prompt's end) fed `forced`
    tokens, or the greedy argmax when `forced` is None: (logits
    [n_steps, V], the tokens fed)."""
    import torch

    dev = model.device
    lm = model.language_model
    lp = model.params["language_model"]
    out = [first]
    toks = []
    for s in range(n_steps - 1):
        tok = int(np.argmax(out[-1])) if forced is None else forced[s]
        toks.append(tok)
        emb = lm.embed(lp, torch.tensor([[tok]], device=dev))
        p = torch.full((3, 1, 1), int(cache.offset) + delta,
                       dtype=torch.int64, device=dev)
        out.append(lm.step_logits(lp, emb, cache, p)[0, 0].float().cpu()
                   .numpy())
    return np.stack(out), toks


def admission_layout_logits(model, prompts: list, row: int, layout: tuple,
                            forced: list, kv_bits) -> tuple:
    """The prompt in row `row` of an admission, prefilled as that admission
    prefilled it (layout (rows, padded length, chunk): the admitted prompts
    `prompts`, each embed_prompt's (embeds [1, S, D], position ids
    [3, 1, S], rope deltas [1, 1]), right-padded
    with zeros into a [rows, padded length] batch, in chunks, the head run
    on each chunk that holds a prompt's last token), then its rows of the
    prefilled cache copied into a one-row cache of the same kind and
    decoded there on the single stream, teacher-forced with `forced`:
    (logits [len(forced) + 1, V], the one-row cache).  None of the
    generator's code runs: not its admission, not insert_row, not its
    per-row cursors or its batch step."""
    import torch

    from mlx_vlm_tpu_torch.core.cache import cache_buffers
    from mlx_vlm_tpu_torch.generate.ar import make_cache
    from mlx_vlm_tpu_torch.generate.batch import prefill_rows

    dev = model.device
    lm = model.language_model
    lp = model.params["language_model"]
    n, S_pad, step = layout
    dtype, D = prompts[0][0].dtype, prompts[0][0].shape[2]
    embeds = torch.zeros((n, S_pad, D), dtype=dtype, device=dev)
    pos = np.zeros((3, n, S_pad), np.int64)
    last = np.zeros(n, np.int64)
    for i, (e, p, _) in enumerate(prompts):
        embeds[i, :e.shape[1]] = e[0]
        pos[:, i, :e.shape[1]] = p[:, 0]
        last[i] = e.shape[1] - 1
    S = int(last[row]) + 1
    cache = make_cache(model, n, 256 * ((S_pad + 255) // 256), dtype,
                       kv_bits, device=dev)
    first = None
    for c0 in range(0, S_pad, step):
        chunk = torch.from_numpy(np.ascontiguousarray(
            pos[:, :, c0:c0 + step])).to(dev)
        in_chunk = (last >= c0) & (last < c0 + step)
        if not in_chunk.any():
            lm(lp, embeds[:, c0:c0 + step], cache, chunk)
            continue
        logits = prefill_rows(model, cache, embeds[:, c0:c0 + step], chunk,
                              torch.from_numpy(np.where(in_chunk, last - c0,
                                                        0)))
        if in_chunk[row]:
            first = logits[row].cpu().numpy()
    n_steps = len(forced) + 1
    single = make_cache(model, 1, 256 * ((S + n_steps + 255) // 256), dtype,
                        kv_bits, device=dev)
    for src, dst in zip(cache_buffers(cache), cache_buffers(single)):
        dst[:, 0, :, :S] = src[:, row, :, :S]
    single.offset.fill_(S)
    logits, _ = forced_steps(model, single, first, int(prompts[row][2][0, 0]),
                             forced, n_steps)
    return logits, single


def parity_rule(ref: np.ndarray, got: np.ndarray) -> tuple:
    """bench.py's rule: |got - ref| <= 0.05 * max(1, max|ref|) per step, and
    equal argmax wherever the reference's top-1/top-2 margin exceeds twice
    that bound."""
    tol = 0.05 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    margin_ok = (top2[:, 1] - top2[:, 0]) > 2 * tol
    same = got.argmax(-1) == ref.argmax(-1)
    ok = err <= tol and bool(np.all(same[margin_ok]))
    return ok, err, tol, int(margin_ok.sum())


def eager_blocks():
    """generate/ar.py's DecodeBlocks with every step eager on the card: the
    reference that phase 3 holds the replayed steps to."""
    from mlx_vlm_tpu_torch.generate import ar

    class Eager(ar.DecodeBlocks):
        def __init__(self, *args):
            super().__init__(*args)
            self.use_graph = False

    return Eager


def replay_matches_eager(model, label: str, kv_bits=None,
                         sampled: bool = False, n: int = 12,
                         block: int = 4) -> bool:
    """A text-only request through generate_step on the card twice: each
    decode step a replay of the captured step (the default), and every step
    eager (`EagerBlocks` in place of the decode loop's `DecodeBlocks`);
    their tokens and logprobs must be bit-identical.
    Greedy, or seeded sampling (temperature 0.8, top-p 0.9) with
    `sampled`.  n tokens in blocks of `block`: the last block is partial.
    The caller sets the environment that picks the cache."""
    import torch

    from mlx_vlm_tpu_torch.core.sampling import make_sampler
    from mlx_vlm_tpu_torch.generate import ar

    ids = torch.tensor([list(range(40, 61))], device=model.device)
    emb = model.get_input_embeddings(model.params, ids)
    runs = {}
    blocks, EagerBlocks = ar.DecodeBlocks, eager_blocks()
    for graph in (True, False):
        sampler = make_sampler(0.8, top_p=0.9) if sampled else None
        ar.DecodeBlocks = blocks if graph else EagerBlocks
        try:
            pairs = list(ar.generate_step(emb, model, max_tokens=n,
                                          sampler=sampler, seed=5,
                                          block_size=block, kv_bits=kv_bits))
        finally:
            ar.DecodeBlocks = blocks
        runs[graph] = (np.stack([t for t, _ in pairs]),
                       np.stack([lp for _, lp in pairs]),
                       dict(ar.last_decode.stats))
    (tg, lg, sg), (te, le, se) = runs[True], runs[False]
    same = (tg.shape == te.shape == (n, 1) and np.array_equal(tg, te)
            and np.array_equal(lg.view(np.uint32), le.view(np.uint32)))
    blocks = -(-(n - 1) // block)
    stats_ok = (sg["replays"] == n - 2 and sg["steps"] == se["steps"] == n - 1
                and sg["fetches"] == se["fetches"] == blocks + 1
                and se["replays"] == 0)
    print(f"  replay vs eager, {label}{', sampled' if sampled else ''}: "
          f"{n} tokens in blocks of {block}: tokens and logprobs "
          f"bit-identical {same}; capture {sg['capture_s']:.4f} s, replays "
          f"{sg['replays']}, fetches {sg['fetches']} (eager: {se['steps']} "
          f"steps, {se['fetches']} fetches) "
          f"{'ok' if same and stats_ok else 'MISMATCH'}", flush=True)
    return same and stats_ok


# Phase 3's batch: three requests (a text prompt, an image prompt, and a
# text prompt inserted after the first cycle) in 3 slots, in blocks of 1
# step: the first two admitted together and given 3 tokens, the third
# admitted alone and given 2, so that the first step runs with the third
# slot idle and the second with all three live at different cursors;
# prefill chunks of 128 rows, so that a short prompt is padded to 128
# rows, not 256.  Each plain prefill chunk or decode step, and each head,
# costs the CPU reference about 2 s at 7B widths on 8 CPU threads (its
# int4 weights dequantized at each call), so the batch runs few: 2
# chunks, 2 steps, 4 heads (3 tokens each in 64-row chunks ran 6 of each:
# 25.0 s a case against 17.9 s on the same CPU)
BATCH_SLOTS, BATCH_BLOCK, BATCH_PREFILL = 3, 1, 128
BATCH_TOKENS = (3, 3, 2)
BATCH_TEXTS = ("Write a haiku about the sea.", "What is in this image?",
               "Name three colors.")
# (kv_bits, the kernel each layer's decode attention runs, its launches
# per layer and step, the CPU reference's dtype, as in PARITY_CASES)
BATCH_CASES = ((None, "int4_matvec", 0, "float32"),
               (4, "int4_kv_attention", 1, "bfloat16"))


class Recorder:
    """A batched sampler that keeps, for every call of a BatchGenerator's
    sampler, the logits (a device copy, so no host read inside a block),
    the tokens it returned and the uid of each row (None for a row that no
    live request owns: an idle slot or a padding row of a batched
    admission), and returns its own greedy tokens or, with `forced`, the
    tokens of the same call of another run.  Admissions take the requests
    in the order they were inserted (`order`, their uids)."""

    def __init__(self, order, forced=None):
        from mlx_vlm_tpu_torch.core.sampling import make_batched_sampler

        self.real = make_batched_sampler()
        self.order, self.admitted = list(order), 0
        self.forced = forced
        self.calls = []
        self.gen = None

    def __call__(self, logits, params, generator):
        gen, rows = self.gen, logits.shape[0]
        if params is gen.params:  # a decode step over the slots
            uids = [s.req.uid if s is not None and gen.active[i] else None
                    for i, s in enumerate(gen.slots)]
        else:  # an admission's first tokens (batched: >= 2 requests)
            n = 1 if rows == 1 else min(len(gen._free_slots()), 8,
                                        len(gen.queue))
            uids = self.order[self.admitted:self.admitted + n]
            uids += [None] * (rows - n)
            self.admitted += n
        toks = (self.real(logits, params, generator) if self.forced is None
                else self.forced[len(self.calls)])
        self.calls.append((logits.float().clone(), toks.clone(), uids))
        return toks

    def results(self) -> list:
        return [(lg.cpu().numpy(), t.cpu().numpy(), u)
                for lg, t, u in self.calls]


def per_request(calls: list, n_tokens: dict) -> dict:
    """{uid: logits [n, V]}: each request's rows of a Recorder's calls in
    order (its admission's, then one a decode step), cut to its n tokens."""
    rows: dict = {}
    for logits, _, uids in calls:
        for r, u in enumerate(uids):
            if u is not None:
                rows.setdefault(u, []).append(logits[r])
    return {u: np.stack(v[:n_tokens[u]]) for u, v in rows.items()}


def batch_requests(model, proc, cfg, inputs_img: dict) -> list:
    """Phase 3's three BatchRequests, embedded by `model` (fresh objects:
    a generator caps their max_tokens in place)."""
    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.generate.batch import BatchRequest
    from mlx_vlm_tpu_torch.generate.common import embed_prompt
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    reqs = []
    for uid, text in enumerate(BATCH_TEXTS):
        if uid == 1:
            inputs = inputs_img
        else:
            inputs = prepare_inputs(proc, apply_chat_template(
                proc, cfg, text, num_images=0))
        embeds, pos, deltas = embed_prompt(model, inputs)
        reqs.append(BatchRequest(uid=uid, inputs_embeds=embeds,
                                 max_tokens=BATCH_TOKENS[uid],
                                 position_ids=pos,
                                 rope_delta=int(deltas[0, 0])))
    return reqs


def drive_batch(model, reqs: list, late=(), graph: bool = True,
                recorder=None, **kw) -> tuple:
    """`reqs` through a BatchGenerator(model, **kw): the requests whose
    index is in `late` inserted after the first cycle, the others before
    it, drained.  `graph` False runs every step eagerly on the card; a
    `recorder` stands in for the sampler.  Returns ({uid: [(token,
    logprob)]}, the generator)."""
    from mlx_vlm_tpu_torch.generate import batch

    real = batch.make_batched_sampler
    if recorder is not None:
        batch.make_batched_sampler = lambda: recorder
    try:
        gen = batch.BatchGenerator(
            model, dtype=reqs[0].inputs_embeds.dtype, **kw)
    finally:
        batch.make_batched_sampler = real
    if recorder is not None:
        recorder.gen = gen
    gen.decode.use_graph = graph and gen.decode.use_graph
    out = {r.uid: [] for r in reqs}

    def cycle():
        for uid, pairs in gen.next().items():
            out[uid].extend(pairs)

    for i, r in enumerate(reqs):
        if i not in late:
            gen.insert(r)
    cycle()
    for i in late:
        gen.insert(reqs[i])
    while gen.num_active or gen.queue:
        cycle()
    return out, gen


def batch_scenario(model, reqs: list, kv_bits, graph: bool = True,
                   recorder=None) -> tuple:
    """Phase 3's batch through drive_batch: reqs[0] and reqs[1] inserted
    together (one batched admission), reqs[2] after the first cycle (a
    single admission)."""
    return drive_batch(model, reqs, late=(2,), graph=graph,
                       recorder=recorder, num_slots=BATCH_SLOTS,
                       capacity=512, block_size=BATCH_BLOCK,
                       prefill_step_size=BATCH_PREFILL, kv_bits=kv_bits)


def batch_parity(ref_calls: list, got_calls: list, n_tokens: dict) -> tuple:
    """Phase 3's batch on the card against the CPU, request by request:
    its admission's logits and its decode steps' by the parity rule, both
    runs' calls serving the same rows.  Returns (ok, worst err, its tol,
    steps with argmax checked, rows compared)."""
    same_calls = (len(ref_calls) == len(got_calls) and all(
        ru == gu for (_, _, ru), (_, _, gu) in zip(ref_calls, got_calls)))
    ref = per_request(ref_calls, n_tokens)
    got = per_request(got_calls, n_tokens)
    ok, worst, worst_tol, checked, rows = same_calls, 0.0, 1.0, 0, 0
    for u in ref:
        good, err, tol, n = parity_rule(ref[u], got[u])
        ok = ok and good
        if err / tol >= worst / worst_tol:
            worst, worst_tol = err, tol
        checked += n
        rows += ref[u].shape[0]
    return ok, worst, worst_tol, checked, rows


def same_pairs(a: dict, b: dict) -> bool:
    """Two runs' {uid: [(token, logprob)]}: tokens equal and logprobs
    bit-identical."""
    return a.keys() == b.keys() and all(
        [t for t, _ in a[u]] == [t for t, _ in b[u]]
        and np.array_equal(np.float32([lp for _, lp in a[u]]).view(
            np.uint32), np.float32([lp for _, lp in b[u]]).view(np.uint32))
        for u in a)


def batch_replay_matches_eager(model, reqs_fn, label: str, kv_bits) -> bool:
    """Phase 3's batch on the card twice: the generator's decode step
    captured once and replayed (the default), and every step eager; tokens
    and logprobs bit-identical, one capture across both admissions."""
    runs = {}
    for graph in (True, False):
        out, gen = batch_scenario(model, reqs_fn(), kv_bits, graph=graph)
        runs[graph] = (out, dict(gen.stats))
    (og, sg), (oe, se) = runs[True], runs[False]
    same = same_pairs(og, oe)
    stats_ok = (sg["captures"] == 1 and sg["replays"] == sg["steps"] - 1
                and se["captures"] == 0 and se["replays"] == 0
                and sg["steps"] == se["steps"]
                and sg["fetches"] == sg["blocks"] + sg["admissions"])
    print(f"  batch replay vs eager, {label}: {len(og)} requests, tokens "
          f"{[len(v) for v in og.values()]}: tokens and logprobs "
          f"bit-identical {same}; {sg['captures']} capture "
          f"({sg['capture_s']:.4f} s), {sg['replays']} replays over "
          f"{sg['admissions']} admissions, {sg['fetches']} fetches "
          f"{'ok' if same and stats_ok else 'MISMATCH'}", flush=True)
    return same and stats_ok


# drafted tokens a speculative round (phase 3's check and phase 4's part)
SPEC_K = 4


# the phase-4 drafter's decoder layers: the 2B's 28 cut to 14, for the
# run's time as MOE_LAYERS; phase 2 runs K3 at all 28
SPEC_DRAFTER_LAYERS = 14


def spec_drafter(n_layers=None, vision_depth=None, seed: int = SEED + 4):
    """A random mlx 4-bit drafter at qwen2_vl_2b_config()'s widths (hidden
    1536, 12 / 2 heads, intermediate 8960; 28 layers unless `n_layers`)
    with the 7B's vocabulary, 152064: both packages refuse the published
    2B vocabulary (151936) beside the 7B target, since
    validate_drafter_compatibility compares vocab sizes.  Loaded onto the
    card in bf16 (w4grp)."""
    import torch

    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.testing import mlx_int4_checkpoint

    cfg = drafter_config()
    if n_layers:
        cfg["num_hidden_layers"] = n_layers
    if vision_depth:
        cfg["vision_config"] = dict(cfg["vision_config"], depth=vision_depth)
    cfg, weights = mlx_int4_checkpoint(cfg, seed=seed)
    return load_model_from_weights(cfg, weights, torch.bfloat16, "cuda")


def spec_replay_matches_eager(model) -> bool:
    """Speculative rounds on the card twice, each round after the first a
    replay of the round captured once (the default) and every round eager
    (`use_graph` False), against a 2-layer drafter at the 2B's widths:
    the single-stream rounds (greedy, and seeded sampling at temperature
    0.8; 24 tokens) and the batched rounds (three requests in three
    slots, the third admitted after the first cycle, the second sampled at
    0.8): tokens, the batch's logprobs and both models' caches (every K/V
    byte and the cursors) bit-identical; one capture per request and per
    generator, none eager."""
    import torch

    from mlx_vlm_tpu_torch.generate.batch import BatchRequest, SamplingParams
    from mlx_vlm_tpu_torch.speculative import batch as sb
    from mlx_vlm_tpu_torch.speculative import utils as su

    drafter = spec_drafter(n_layers=2, vision_depth=1, seed=SEED + 5)
    dev = model.device

    def same_caches(a: list, b: list) -> bool:
        return all(torch.equal(getattr(x, f), getattr(y, f))
                   for x, y in zip(a, b) for f in ("k", "v", "offset"))

    def embeds(ids):
        return model.get_input_embeddings(
            model.params, torch.from_numpy(ids).to(dev))

    ok = True
    ids = np.arange(40, 61)[None]
    for temp in (0.0, 0.8):
        runs = {}
        for graph in (True, False):
            real = su.SpeculativeRounds

            class Eager(real):
                def __init__(self, *args):
                    super().__init__(*args)
                    self.use_graph = False

            su.SpeculativeRounds = real if graph else Eager
            try:
                toks = [int(t[0]) for t, _ in su.speculative_generate_step(
                    embeds(ids), model, drafter, input_ids=ids, max_tokens=24,
                    num_draft=SPEC_K, temperature=temp, seed=5)]
            finally:
                su.SpeculativeRounds = real
            r = su.last_rounds
            runs[graph] = (toks, [r.cache, r.d_cache], dict(r.stats))
        (tg, cg, sg), (te, ce, se) = runs[True], runs[False]
        same = tg == te and len(tg) == 24 and same_caches(cg, ce)
        counts_ok = (sg["captures"] == 1 and sg["replays"] == sg["rounds"] - 1
                     and se["captures"] == se["replays"] == 0
                     and sg["rounds"] == se["rounds"])
        print(f"  speculative replay vs eager, single stream, temperature "
              f"{temp}: 24 tokens in {sg['rounds']} rounds of k = {SPEC_K}: "
              f"tokens and both caches bit-identical {same}; capture "
              f"{sg['capture_s']:.4f} s, {sg['replays']} replays "
              f"{'ok' if same and counts_ok else 'MISMATCH'}", flush=True)
        ok = ok and same and counts_ok
    prompts = [(np.arange(40, 61)[None], 12, 0.0),
               (np.arange(100, 133)[None], 12, 0.8),
               (np.arange(7, 19)[None], 8, 0.0)]
    runs = {}
    for graph in (True, False):
        gen = sb.SpeculativeBatchGenerator(
            model, drafter, num_draft=SPEC_K, num_slots=3, capacity=512,
            prefill_step_size=128, dtype=torch.bfloat16)
        gen.decode.use_graph = graph and gen.decode.use_graph
        reqs = [BatchRequest(uid=u, inputs_embeds=embeds(p), max_tokens=n,
                             input_ids=p, sampling=SamplingParams(temp=t))
                for u, (p, n, t) in enumerate(prompts)]
        out = {u: [] for u in range(len(reqs))}

        def cycle():
            for uid, pairs in gen.next().items():
                out[uid].extend(pairs)

        gen.insert(reqs[0])
        gen.insert(reqs[1])
        cycle()
        gen.insert(reqs[2])
        while gen.num_active or gen.queue:
            cycle()
        runs[graph] = (out, [gen.cache, gen.d_cache], dict(gen.decode.stats))
    (og, cg, sg), (oe, ce, se) = runs[True], runs[False]
    same = same_pairs(og, oe) and same_caches(cg, ce)
    counts_ok = (sg["captures"] == 1 and sg["replays"] == sg["rounds"] - 1
                 and se["captures"] == se["replays"] == 0
                 and sg["rounds"] == se["rounds"]
                 and [len(v) for v in og.values()] == [12, 12, 8])
    print(f"  speculative replay vs eager, batch of 3 slots (one admitted "
          f"late, one sampled): tokens {[len(v) for v in og.values()]} in "
          f"{sg['rounds']} rounds over {sg['admissions']} admissions: tokens, "
          f"logprobs and both caches bit-identical {same}; "
          f"{sg['captures']} capture ({sg['capture_s']:.4f} s), "
          f"{sg['replays']} replays {'ok' if same and counts_ok else 'MISMATCH'}",
          flush=True)
    del drafter
    su.last_rounds = None
    return ok and same and counts_ok


# teacher-forced steps of phase 3's video prompts
VIDEO_STEPS = 4


def video_parity(gpu, videos: dict, refs: dict, family: str, ref_dtype: str,
                 want: dict) -> bool:
    """Each of `videos` (name -> prepare_inputs' arrays) on the card
    (bf16, kernels), teacher-forced with its CPU reference's tokens
    (`refs`: name -> (logits, tokens)), held to it by the parity rule, its
    launches to `want`."""
    all_ok = True
    for name, inputs in videos.items():
        ref, toks = refs[name]
        reset_counts()
        got, _ = teacher_forced_logits(gpu, inputs, forced=toks,
                                       n_steps=VIDEO_STEPS)
        counts = read_counts()
        ok, err, tol, n_margin = parity_rule(ref, got)
        grids = {k: inputs[k].tolist() for k in ("image_grid_thw",
                                                "video_grid_thw")
                 if k in inputs}
        print(f"  {family}, {name} (4 frames): prompt "
              f"{inputs['input_ids'].shape[1]} tokens, grids {grids}; vs "
              f"the CPU in {ref_dtype}: max|cuda - cpu| = {err:.4e}, tol "
              f"{tol:.4e}; argmax checked on {n_margin}/{VIDEO_STEPS} steps; "
              f"launches {counts} (want {want}) "
              f"{'ok' if ok and counts == want else 'MISMATCH'}", flush=True)
        all_ok = all_ok and ok and counts == want
    return all_ok


# (kv_bits, MLX_VLM_TPU_TQ_SCHEME, the kernel each decode step runs,
# launches per layer and step, the CPU reference's dtype, teacher-forced
# steps).  The bf16 cache is held to an f32 CPU run.  A quantized cache is
# held to a CPU run in the card's working type, bf16: against f32, every
# k/v element that bf16 rounding moves across a code boundary flips a
# code, and the random stack amplifies the flips (0.37-0.47 against the
# 0.31 bound at 2 layers on the H100, where the bf16 cache drifts 0.21).
# The f32 case's 4 steps hold its K3 route 3 times; the run's time limit
# leaves no room for more (its CPU reference is most of the case).
PARITY_CASES = (
    (None, None, "fused_decode", 0, "float32", 4),
    (4, None, "int4_kv_attention", 1, "bfloat16", 4),
    (3.5, None, "tq_kv_attention", 1, "bfloat16", 4),
    (3.5, "split", "tq_kv_attention_split", 1, "bfloat16", 4),
)


def phase_slice_parity(ckpt: tuple) -> bool:
    """The slice on the card (bf16, kernels) vs on the CPU (plain versions),
    7B widths with 2 decoder layers (the first two of `ckpt`, phase 4's
    Qwen2-VL-7B checkpoint), for the bf16 cache (K3) and the quantized
    caches (K6, K7, K8)."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    n_layers = 2
    print(f"phase 3: slice on the card (bf16, kernels) vs on the CPU (plain "
          f"versions), Qwen2-VL-7B widths, {n_layers} decoder layers, "
          f"teacher-forced, for each cache", flush=True)
    t0 = time.perf_counter()
    clock = [t0]

    def lap(what: str) -> None:
        clock.append(time.perf_counter())
        print(f"  ({what}: {clock[-1] - clock[-2]:.1f} s)", flush=True)

    cfg, weights = sliced(ckpt, n_layers)
    proc = _processor()
    prompt = apply_chat_template(proc, cfg, "What is in this image?",
                                 num_images=1)
    inputs = prepare_inputs(proc, prompt, images=_image(224))
    clip = phase3_clip(proc)
    videos = {"a video": video_inputs(proc, cfg, "What happens?", clip),
              "an image and a video": video_inputs(
                  proc, cfg, "Compare them.", clip, _image(224))}
    lap("checkpoint")
    refs, batch_refs, route, video_refs = {}, {}, True, {}
    for dtype in ("float32", "bfloat16"):
        cpu = load_model_from_weights(cfg, weights, getattr(torch, dtype),
                                      "cpu")
        route = route and cpu.language_model.fused_decode
        for kv_bits, tq, _, _, ref_dtype, n_steps in PARITY_CASES:
            if ref_dtype == dtype:
                with env_vars(MLX_VLM_TPU_TQ_SCHEME=tq):
                    refs[kv_bits, tq] = teacher_forced_logits(
                        cpu, inputs, n_steps=n_steps, kv_bits=kv_bits)
        if dtype == "float32":
            for name, vin in videos.items():
                video_refs[name] = teacher_forced_logits(
                    cpu, vin, n_steps=VIDEO_STEPS)
        lap(f"CPU {dtype} load and single-stream references")
        for kv_bits, _, _, ref_dtype in BATCH_CASES:
            if ref_dtype == dtype:
                rec = Recorder(range(len(BATCH_TEXTS)))
                out, _ = batch_scenario(
                    cpu, batch_requests(cpu, proc, cfg, inputs), kv_bits,
                    recorder=rec)
                batch_refs[kv_bits] = (rec.results(),
                                       {u: len(v) for u, v in out.items()})
                lap(f"CPU batch reference, kv_bits={kv_bits}")
        del cpu
    gpu = load_model_from_weights(cfg, weights, torch.bfloat16, "cuda")
    route = route and gpu.language_model.fused_decode
    all_ok = route
    lap("card load")
    for kv_bits, tq, kernel, per_layer, ref_dtype, n_steps in PARITY_CASES:
        ref, toks = refs[kv_bits, tq]
        reset_counts()
        with env_vars(MLX_VLM_TPU_TQ_SCHEME=tq):
            got, _ = teacher_forced_logits(gpu, inputs, forced=toks,
                                           n_steps=n_steps, kv_bits=kv_bits)
        n = read_counts()[kernel]
        want = (n_steps - 1) * (n_layers * per_layer or 1)
        ok, err, tol, n_margin = parity_rule(ref, got)
        print(f"  kv_bits={kv_bits} tq_scheme={tq} vs the CPU in {ref_dtype}: "
              f"prompt {inputs['input_ids'].shape[1]} tokens: max|cuda - cpu| "
              f"= {err:.4e}, tol {tol:.4e}; argmax checked on {n_margin}/"
              f"{n_steps} steps; {kernel} launches {n} (want {want}); "
              f"{'ok' if ok and n == want else 'MISMATCH'}", flush=True)
        all_ok = all_ok and ok and n == want
    lap("card single-stream cases")
    all_ok = video_parity(gpu, videos, video_refs, "Qwen2-VL", "float32",
                          family_want("w4grp", gpu.language_model,
                                      VIDEO_STEPS)) and all_ok
    lap("card video cases")
    # the batch (K2 at M = 3, per-row cursors) held to the CPU, teacher-
    # forced with the CPU's greedy tokens, every step eager on the card
    for kv_bits, kernel, per_layer, ref_dtype in BATCH_CASES:
        ref, n_tokens = batch_refs[kv_bits]
        rec = Recorder(range(len(BATCH_TEXTS)),
                       [torch.from_numpy(t).to(gpu.device) for _, t, _ in ref])
        reset_counts()
        _, gen = batch_scenario(gpu, batch_requests(gpu, proc, cfg, inputs),
                                kv_bits, graph=False, recorder=rec)
        counts = read_counts()
        st = gen.stats
        want = {"int4_matvec": (7 * n_layers + 1) * st["steps"]
                + st["prefill_heads"],
                "int4_matmul": 7 * n_layers * st["prefill_chunks"],
                "fused_decode": 0,
                "int4_kv_attention": n_layers * st["steps"] * per_layer}
        counts_ok = all(counts[k] == v for k, v in want.items())
        ok, err, tol, n_margin, rows = batch_parity(ref, rec.results(),
                                                    n_tokens)
        print(f"  batch of {BATCH_SLOTS} slots ({', '.join(BATCH_TEXTS)}; "
              f"the last admitted late), kv_bits={kv_bits}, eager on the "
              f"card vs the CPU in {ref_dtype}: {rows} logit rows over "
              f"{len(ref)} sampler calls; worst max|cuda - cpu| = "
              f"{err:.4e}, tol {tol:.4e}; argmax checked on {n_margin} "
              f"rows; {st['steps']} decode steps, {st['admissions']} "
              f"admissions, {st['prefill_chunks']} prefill chunks; launches "
              f"{ {k: counts[k] for k in want} } (want {want}); "
              f"{'ok' if ok and counts_ok else 'MISMATCH'}", flush=True)
        all_ok = all_ok and ok and counts_ok
        lap(f"card batch, kv_bits={kv_bits}, teacher-forced")
        all_ok = batch_replay_matches_eager(
            gpu, lambda: batch_requests(gpu, proc, cfg, inputs),
            f"kv_bits={kv_bits} ({kernel})", kv_bits) and all_ok
        lap(f"card batch, kv_bits={kv_bits}, replay and eager")
    # the graph-replayed block decode against eager steps, for each cache
    for kv_bits, tq, kernel, _, _, _ in PARITY_CASES:
        with env_vars(MLX_VLM_TPU_TQ_SCHEME=tq):
            all_ok = replay_matches_eager(
                gpu, f"kv_bits={kv_bits} tq_scheme={tq} ({kernel})",
                kv_bits) and all_ok
    all_ok = replay_matches_eager(gpu, "bf16 cache (fused_decode)",
                                  sampled=True) and all_ok
    gpu.language_model.fused_decode = False
    all_ok = replay_matches_eager(gpu, "bf16 cache, per-linear (int4_matvec)"
                                  ) and all_ok
    gpu.language_model.fused_decode = True
    lap("card single-stream replay vs eager")
    all_ok = spec_replay_matches_eager(gpu) and all_ok
    lap("card speculative rounds, replay vs eager")
    del gpu, weights
    torch.cuda.empty_cache()
    print(f"  fused route on all: {route} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return all_ok


# The new families on the card against the CPU: (label, checkpoint,
# decoder layers, MLX_VLM_TPU_RUNTIME_QUANT (None: the default), the
# layout its linears load in, the CPU reference's dtype, teacher-forced
# steps).  Qwen3-VL keeps 3 decoder layers, so that each of its 3
# deepstack levels is added.  Qwen2.5-VL is held to a CPU run in the
# card's working type, bf16: its image features (std about 1.4, some 70
# times the text embeddings' on these random weights) carry the 32-block
# tower's bf16 roundings (1.2% of their scale after 8 blocks, as
# Qwen2-VL's tower) into the residual stream, and against an f32 run the
# card measured 0.3149 past the tolerance of 0.3018 (NVIDIA H100 80GB
# HBM3, 700 W), where Qwen2-VL's image prompt measures 0.19 of 0.35.
# The f32 cases of Qwen3-VL, Qwen3-VL-MoE, Llama-3.1-8B and LLaVA-1.5-7B
# run 2 teacher-forced steps (a decode step after the prefill holds each
# route once), and Llama-3.1-8B's w8chan case 1 decoder layer: their f32
# CPU references are most of phase 3, and the run's time limit leaves no
# room for more.
FAMILY_CASES = (
    ("Qwen2.5-VL, w4grp (K3 decode)", "qwen2_5_vl_7b", 2, None,
     "Int4GroupedTensor", "bfloat16", 8),
    ("Qwen3-VL, w8chan", "qwen3_vl_8b", 3, None, "ChannelQuantizedTensor",
     "float32", 2),
    ("Qwen3-VL, exact (K5)", "qwen3_vl_8b", 3, "exact", "QuantizedTensor",
     "float32", 2),
    ("Qwen3-VL-MoE, default (w8chan; experts on K5)", "qwen3_vl_moe_30b_a3b",
     2, None, "ChannelQuantizedTensor", "float32", 2),
    ("Qwen3-VL-MoE, exact (K5; 8-bit router)", "qwen3_vl_moe_30b_a3b", 2,
     "exact", "QuantizedTensor", "float32", 2),
    ("Llama-3.1-8B, w8chan", "llama_3_1_8b", 1, None,
     "ChannelQuantizedTensor", "float32", 2),
    ("Llama-3.1-8B, exact (K5)", "llama_3_1_8b", 2, "exact",
     "QuantizedTensor", "float32", 2),
    ("LLaVA-1.5-7B, w8chan", "llava_1_5_7b", 2, None,
     "ChannelQuantizedTensor", "float32", 2),
    ("LLaVA-1.5-7B, exact (K5)", "llava_1_5_7b", 2, "exact",
     "QuantizedTensor", "float32", 2),
) + tuple(
    # the text MoE decoders at their published widths, text only, 2
    # teacher-forced steps (their CPU references dequantize every expert
    # of a layer at each forward: a Mixtral expert projection takes 0.3 s
    # on 8 host threads, so Mixtral, Phi-3.5-MoE and Qwen1.5-MoE keep 1
    # layer); the default mode (w8chan linears and routers, the experts on
    # K5) for all six, exact for Qwen3-30B-A3B (Mixtral's exact case, 17.5
    # s of CPU, was cut for the run's time: Mixtral runs exact in phase 4).
    # Qwen3-30B-A3B is held to a CPU run in the card's working type, bf16:
    # its router picks 8 of 128 experts, and at near-ties bf16 and f32
    # scores pick different ones, so that against f32 runs the card
    # measured 0.2097 of the tolerance 0.2154 (default, 4 steps) and
    # 0.2159, past 0.2134 (exact, the third of 4 steps), where the other
    # families' errors are 0.06-0.35 of theirs; against bf16 runs 0.1387 of
    # 0.2266 and 0.1484 of 0.2141 (NVIDIA H100 80GB HBM3, 700 W)
    (f"{title}, {'exact (K5; 8-bit router)' if mode else 'default (w8chan; experts on K5)'}",
     name, n_layers, mode,
     "QuantizedTensor" if mode else "ChannelQuantizedTensor", ref_dtype, 2)
    for title, name, n_layers, mode, ref_dtype in (
        ("Qwen3-30B-A3B", "qwen3_30b_a3b", 2, None, "bfloat16"),
        ("Qwen3-30B-A3B", "qwen3_30b_a3b", 2, "exact", "bfloat16"),
        ("Qwen1.5-MoE-A2.7B", "qwen1_5_moe_a2_7b", 1, None, "float32"),
        ("Mixtral-8x7B", "mixtral_8x7b", 1, None, "float32"),
        ("OLMoE-1B-7B", "olmoe_1b_7b", 2, None, "float32"),
        ("Phi-3.5-MoE", "phi_3_5_moe", 1, None, "float32"),
        ("Granite-3.0-3B-A800M", "granite_3_0_3b_a800m", 2, None,
         "float32"))) + (
    # PaliGemma2-3B and PaliGemma-3B at their published widths, 2 decoder
    # layers, the whole 27-block SigLIP tower and one 224 x 224 image,
    # default (w8chan) and exact (K5: every linear and the tied head);
    # their text models as text-only gemma2 / gemma checkpoints on the
    # same arrays.  2 teacher-forced steps but PaliGemma2's exact case's 4:
    # each CPU step runs the 257216-row head in f32
    ("PaliGemma2-3B, w8chan", "paligemma2_3b", 2, None,
     "ChannelQuantizedTensor", "float32", 2),
    ("PaliGemma2-3B, exact (K5)", "paligemma2_3b", 2, "exact",
     "QuantizedTensor", "float32", 4),
    ("PaliGemma-3B, w8chan", "paligemma_3b", 2, None,
     "ChannelQuantizedTensor", "float32", 2),
    ("PaliGemma-3B, exact (K5)", "paligemma_3b", 2, "exact",
     "QuantizedTensor", "float32", 2),
    ("Gemma-2-2B text, exact (K5)", "gemma2_2b", 2, "exact",
     "QuantizedTensor", "float32", 2),
    ("Gemma-2B text, w8chan", "gemma_2b", 2, None, "ChannelQuantizedTensor",
     "float32", 2)) + (
    # gpt-oss-20b at its published widths, 2 decoder layers (one sliding,
    # one full; sinks on), exact: K5 on o and the experts (q / k / v, the
    # router and the head take the dequantize route at K = 2880), held to
    # a bf16 CPU run as Qwen3-30B-A3B is (top-4 of 32 near-ties); phi-2 at
    # its widths, 2 layers, exact; Llama-3.1-8B at 1 layer, exact, with a
    # rank-16 LoRA and DoRA on q / v (FAMILY_ADAPTERS)
    ("gpt-oss-20b, exact (K5: o, experts)", "gpt_oss_20b", 2, "exact",
     "QuantizedTensor", "bfloat16", 2),
    ("phi-2, exact (K5)", "phi_2", 2, "exact", "QuantizedTensor", "float32",
     2),
    ("Llama-3.1-8B + LoRA r16 on q / v, exact (K5)", "llama_3_1_8b", 1,
     "exact", "QuantizedTensor", "float32", 2),
    ("Llama-3.1-8B + DoRA r16 on q / v, exact (K5)", "llama_3_1_8b", 1,
     "exact", "QuantizedTensor", "float32", 2))
# FAMILY_CASES whose models carry an adapter (label -> DoRA), and the
# cases whose K5 launches `k5_linears` counts from the loaded tree
FAMILY_ADAPTERS = {"Llama-3.1-8B + LoRA r16 on q / v, exact (K5)": False,
                   "Llama-3.1-8B + DoRA r16 on q / v, exact (K5)": True}
COUNTED_CASES = ("gpt-oss-20b, exact (K5: o, experts)", "phi-2, exact (K5)",
                 *FAMILY_ADAPTERS)
ADAPTER_RANK = 16
# the FAMILY_CASES whose models also take phase 3's clip (label -> the
# family's name): Qwen2.5-VL's window tower and scaled times, Qwen3-VL's
# timestamped frame groups
VIDEO_FAMILY_CASES = {"Qwen2.5-VL, w4grp (K3 decode)": "Qwen2.5-VL",
                      "Qwen3-VL, w8chan": "Qwen3-VL"}
# each checkpoint's phase-3 image: the Qwen-VL line's 224 x 224 (no
# resize at patch 14 or 16), LLaVA's 336 x 336 (its crop size, so the
# processor needs no PIL), none for the text-only Llama
FAMILY_IMAGE = {"llama_3_1_8b": None, "llava_1_5_7b": 336,
                "qwen3_30b_a3b": None, "qwen1_5_moe_a2_7b": None,
                "mixtral_8x7b": None, "olmoe_1b_7b": None,
                "phi_3_5_moe": None, "granite_3_0_3b_a800m": None,
                "gemma2_2b": None, "gemma_2b": None, "gpt_oss_20b": None,
                "phi_2": None}


def vision_depth(model) -> int:
    """The vision tower's blocks (0 for a text-only model)."""
    vc = getattr(model.config, "vision_config", None)
    return getattr(vc, "depth", getattr(vc, "num_hidden_layers", 0))


def k5_linears(lp: dict) -> tuple:
    """({K5 counter: launches a layer}, {counter: launches a head}) of one
    forward of a language model's tree `lp`: every 2-D mlx weight of layer
    0 that K5's route rule takes (a DoRA's base is dequantized instead; an
    expert stack is 3-D), and the head (the untied `lm_head`, else a tied
    table) likewise."""
    from mlx_vlm_tpu_torch.core.quant import QuantizedTensor, qmm_kernel_route
    from mlx_vlm_tpu_torch.models.base import layer_view

    def routed(p, out):
        w = p.get("weight")
        if (isinstance(w, QuantizedTensor) and "dora_m" not in p
                and qmm_kernel_route(w)):
            key = f"qmatmul_int{w.bits}"
            out[key] = out.get(key, 0) + 1

    per, head = {}, {}

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                routed(v, per)
                walk(v)

    walk(layer_view(lp["model"]["layers"], 0))
    mp = lp["model"]
    routed(lp.get("lm_head") or mp.get("embed_tokens") or mp.get("wte")
           or {}, head)
    return per, head


def gpt_oss_experts_want(want: dict, n_layers: int, forwards: int) -> dict:
    """gpt-oss's expert layers over `forwards` forward passes: one
    expert-indexed launch a projection on the decode route, and on the
    prefill route (core/moe.py `stats`) one a projection and expert with
    rows, since K5's 2-D rule refuses each [2880, 2880] slice at 4 bits
    and the route takes the expert-indexed entry instead."""
    from mlx_vlm_tpu_torch.core import moe

    want["qmatmul_experts"] = 3 * (n_layers * forwards
                                   - moe.stats["grouped_calls"]
                                   + moe.stats["grouped_experts"])
    return want


def family_want(label: str, lm, n_steps: int, lp=None) -> dict:
    """Launches of FAMILY_CASES' teacher-forced run (one unpadded prefill
    chunk with its head at M = 1, then n_steps - 1 decode steps): on the
    fused route K1 for the chunk's linears, K2 for its head and K3 each
    step; exact K5 on every linear and the head of the chunk and of each
    step; w8chan no kernel (K4 takes no chunk this short).  The MoE
    models (Qwen3-VL-MoE and the text MoE decoders): their expert layers
    by `moe_want`, and in exact K5 on the 4 attention linears and the head
    (4 bits) and the router (8 bits).  COUNTED_CASES (gpt-oss, phi-2,
    the adapted Llamas): K5 on what `k5_linears` finds in the tree `lp`,
    gpt-oss's experts by `gpt_oss_experts_want`."""
    want = {k: 0 for k in read_counts()}
    L = lm.args.num_hidden_layers
    if label in COUNTED_CASES:
        per, head = k5_linears(lp)
        for k in set(per) | set(head):
            want[k] = n_steps * (L * per.get(k, 0) + head.get(k, 0))
        if lm.args.model_type == "gpt_oss":
            gpt_oss_experts_want(want, L, n_steps)
        return want
    if hasattr(lm, "top_k"):  # the MoE language model
        want = moe_want(want, L, n_steps)
        if "exact" in label:
            want["qmatmul_int4"] += n_steps * (4 * L + 1)
            want["qmatmul_int8"] = n_steps * L
    elif lm.fused_decode:
        want.update(int4_matmul=7 * L, int4_matvec=1,
                    fused_decode=n_steps - 1)
    elif "exact" in label:
        want["qmatmul_int4"] = n_steps * (7 * L + 1)
    return want


def card_adapter(model, dora: bool, seed: int) -> dict:
    """A rank-ADAPTER_RANK adapter on q_proj / v_proj of every layer of a
    loaded llama-family model (trainer/lora.py's layout: f32 factors
    stacked [L, ...], on the CPU), drawn from `seed`: lora_a ~ N(0, 1/K),
    lora_b ~ N(0, 0.02^2); with `dora`, a magnitude of each base row's
    norm (its weight dequantized in f32) times 1 + U(-0.1, 0.1)."""
    import torch

    from mlx_vlm_tpu_torch.core.layers import dense_weight

    gen = torch.Generator().manual_seed(seed)
    attn = model.params["language_model"]["model"]["layers"]["self_attn"]
    r, out = ADAPTER_RANK, {}
    for name in ("q_proj", "v_proj"):
        w = attn[name]["weight"]
        L, N, K = w.shape
        fac = {"lora_a": torch.randn((L, r, K), generator=gen) / K**0.5,
               "lora_b": torch.randn((L, N, r), generator=gen) * 0.02}
        if dora:
            norms = torch.stack([dense_weight(w.layer(i)).float().norm(
                dim=-1).cpu() for i in range(L)])
            fac["dora_m"] = norms * (1 + 0.2 * (torch.rand(
                (L, N), generator=gen) - 0.5))
        out[f"language_model.model.layers.self_attn.{name}"] = fac
    return out


def attach(model, adapter: dict) -> None:
    """`adapter` attached to the model's tree on its device
    (trainer/lora.py `attach_lora`) and its fused route decided again."""
    from mlx_vlm_tpu_torch.trainer.lora import attach_lora
    from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode

    model.params = attach_lora(model.params, {
        p: {k: v.to(model.device) for k, v in fac.items()}
        for p, fac in adapter.items()})
    decide_fused_decode(model)


def phase_family_parity(ckpts: dict) -> bool:
    """Qwen2.5-VL at 7B widths (2 decoder layers, its whole windowed tower),
    Qwen3-VL at 8B widths (3 decoder layers, its whole deepstack tower),
    Qwen3-VL-MoE at 30B-A3B widths (2 decoder layers of 128 experts, top-8,
    the whole tower; default mode and exact, its 8-bit routers),
    Llama-3.1-8B (2 decoder layers, text only; exact) and LLaVA-1.5-7B (2
    decoder layers, the whole 24-block CLIP tower; its default w8chan mode
    and exact), PaliGemma2-3B and PaliGemma-3B (2 decoder layers, the whole
    SigLIP tower; default and exact) and their text models as text-only
    Gemma-2-2B and Gemma-2B, and the text MoE decoders (Qwen3-30B-A3B,
    Qwen1.5-MoE-A2.7B, Mixtral-8x7B, OLMoE-1B-7B, Phi-3.5-MoE and
    Granite-3.0-3B-A800M, 1 or 2 decoder layers at their published widths,
    8-bit routers; the default mode, and exact for Qwen3-30B-A3B), on the
    card (bf16, kernels) against the CPU (plain versions,
    in f32 or bf16 by FAMILY_CASES), each on its own prompt (an image one
    but for the text models, FAMILY_IMAGE) and processor (patch 14; 16;
    CLIP's 336 crop; each text family's special tokens), teacher-forced by
    the parity rule, its launches held to what ran; then each model's
    graph-replayed decode against eager steps on the card."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.generate.common import embed_prompt
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    print("phase 3: Qwen2.5-VL (7B widths), Qwen3-VL (8B widths), "
          "Qwen3-VL-MoE (30B-A3B widths), Llama-3.1-8B, LLaVA-1.5-7B and "
          "the text MoE decoders (Qwen3-30B-A3B, Qwen1.5-MoE-A2.7B, "
          "Mixtral-8x7B, OLMoE-1B-7B, Phi-3.5-MoE, Granite-3.0-3B-A800M) on "
          "the card vs the CPU, teacher-forced", flush=True)
    all_ok = True
    for (label, name, n_layers, mode, layout, ref_dtype,
         n_steps) in FAMILY_CASES:
        t0 = time.perf_counter()
        cfg, weights = sliced(ckpts[name], n_layers)
        with env_vars(MLX_VLM_TPU_RUNTIME_QUANT=mode):
            cpu = load_model_from_weights(cfg, weights,
                                          getattr(torch, ref_dtype), "cpu")
            adapter = None
            if label in FAMILY_ADAPTERS:
                adapter = card_adapter(cpu, FAMILY_ADAPTERS[label],
                                       SEED + 21)
                attach(cpu, adapter)
            proc = _processor(model=cpu)
            size = FAMILY_IMAGE.get(name, 224)
            prompt = apply_chat_template(proc, cfg, "What is in this image?",
                                         num_images=int(size is not None))
            inputs = prepare_inputs(proc, prompt, images=None if size is None
                                    else _image(size))
            ref, toks = teacher_forced_logits(cpu, inputs, n_steps=n_steps)
            videos = {}
            if label in VIDEO_FAMILY_CASES:
                videos = {"a video": video_inputs(proc, cfg, "What happens?",
                                                  phase3_clip(proc))}
                video_refs = {k: teacher_forced_logits(cpu, v,
                                                       n_steps=VIDEO_STEPS)
                              for k, v in videos.items()}
            del cpu
            t1 = time.perf_counter()
            gpu = load_model_from_weights(cfg, weights, torch.bfloat16,
                                          "cuda")
            if adapter is not None:
                attach(gpu, adapter)
            reset_counts()
            got, _ = teacher_forced_logits(gpu, inputs, forced=toks,
                                           n_steps=n_steps)
            counts = read_counts()
        lm = gpu.language_model
        lp = gpu.params["language_model"]
        layers = lp["model"]["layers"]
        kind = type(layers.get("self_attn", layers.get("attn"))["q_proj"][
            "weight"]).__name__
        layout_ok = kind == layout and lm.fused_decode == (
            layout == "Int4GroupedTensor")
        want = family_want(label, lm, n_steps, lp)
        counts_ok = counts == want
        ok, err, tol, n_margin = parity_rule(ref, got)
        image = (f"grid {inputs['image_grid_thw'].tolist()}"
                 if "image_grid_thw" in inputs else
                 f"pixels {list(inputs['pixel_values'].shape)}"
                 if "pixel_values" in inputs else "no image")
        print(f"  {label}, {n_layers} decoder layers, vision depth "
              f"{vision_depth(gpu)}: prompt "
              f"{inputs['input_ids'].shape[1]} tokens, {image}, embeddings "
              f"width "
              f"{embed_prompt(gpu, inputs)[0].shape[-1]}; "
              f"{kind}, fused route {lm.fused_decode}; vs the CPU in "
              f"{ref_dtype}: max|cuda - cpu| = {err:.4e}, tol {tol:.4e}; argmax checked on {n_margin}/"
              f"{n_steps} steps; launches {counts} (want {want}); CPU "
              f"{t1 - t0:.1f} s, card {time.perf_counter() - t1:.1f} s "
              f"{'ok' if ok and counts_ok and layout_ok else 'MISMATCH'}",
              flush=True)
        if videos:
            with env_vars(MLX_VLM_TPU_RUNTIME_QUANT=mode):
                all_ok = video_parity(
                    gpu, videos, video_refs, VIDEO_FAMILY_CASES[label],
                    ref_dtype, family_want(label, lm, VIDEO_STEPS)) and all_ok
        with env_vars(MLX_VLM_TPU_RUNTIME_QUANT=mode):
            replay_ok = replay_matches_eager(gpu, label)
        all_ok = all_ok and ok and counts_ok and layout_ok and replay_ok
        del gpu, weights
        torch.cuda.empty_cache()
    return all_ok


# Runtime quantization modes: (label, checkpoint bits,
# MLX_VLM_TPU_RUNTIME_QUANT (None: the default, w8chan for 8 bits), kv_bits,
# MLX_VLM_TPU_KV_SCHEME, the K5 counter every linear and the head run, the
# CPU reference's dtype).  The exact-8 case's quantized cache is held to a
# bf16 CPU run for the reason given at PARITY_CASES.
QUANT_CASES = (
    ("exact-4", 4, "exact", None, None, "qmatmul_int4", "float32"),
    ("w8chan-8", 8, None, None, None, None, "float32"),
    ("exact-8, kv_bits 8 affine", 8, "exact", 8, "affine", "qmatmul_int8",
     "bfloat16"),
)
# 2 steps: the cases cost 183 s at 4 (the w8chan loads' host requantization
# in float64 most of it), past the ~120 s that phase 3 may grow by
QUANT_STEPS = 2
# every counter that a per-linear exact or w8chan model must leave at 0
# besides the other K5 variant (K4 may run its prefill attention)
NOT_ON_QUANT_PATH = ("int4_matmul", "int4_matvec", "fused_decode",
                     "int4_kv_attention", "tq_kv_attention",
                     "tq_kv_attention_split")


def phase_quant_parity(n_layers: int = 2) -> bool:
    """The exact and w8chan layouts on the card (bf16, K5) against the CPU
    (plain versions), 7B widths with `n_layers` decoder layers, random mlx
    checkpoints, teacher-forced; each model loaded through
    load_model_from_weights with its mode set."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs
    from mlx_vlm_tpu_torch.utils.testing import (mlx_quantized_checkpoint,
                                                 qwen2_vl_7b_config)

    print(f"phase 3: runtime quantization modes on the card vs the CPU, "
          f"Qwen2-VL-7B widths, {n_layers} decoder layers, {QUANT_STEPS} "
          f"teacher-forced steps", flush=True)
    base = qwen2_vl_7b_config()
    base["num_hidden_layers"] = n_layers
    proc = _processor()
    prompt = apply_chat_template(proc, base, "What is in this image?",
                                 num_images=1)
    inputs = prepare_inputs(proc, prompt, images=_image(224))
    ckpts, all_ok = {}, True
    for label, bits, mode, kv_bits, scheme, counter, ref_dtype in QUANT_CASES:
        t0 = time.perf_counter()
        if bits not in ckpts:
            ckpts[bits] = mlx_quantized_checkpoint(base, bits=bits,
                                                   seed=SEED + 1)
        cfg, weights = ckpts[bits]
        with env_vars(MLX_VLM_TPU_RUNTIME_QUANT=mode,
                      MLX_VLM_TPU_KV_SCHEME=scheme):
            cpu = load_model_from_weights(cfg, weights,
                                          getattr(torch, ref_dtype), "cpu")
            ref, toks = teacher_forced_logits(cpu, inputs, n_steps=QUANT_STEPS,
                                              kv_bits=kv_bits)
            del cpu
            gpu = load_model_from_weights(cfg, weights, torch.bfloat16, "cuda")
            reset_counts()
            got, _ = teacher_forced_logits(gpu, inputs, forced=toks,
                                           n_steps=QUANT_STEPS,
                                           kv_bits=kv_bits)
            counts = read_counts()
        lp = gpu.params["language_model"]
        layouts = {type(lp["lm_head"]["weight"]).__name__,
                   type(lp["model"]["layers"]["mlp"]["up_proj"]["weight"])
                   .__name__}
        layouts_ok = layouts == {"QuantizedTensor" if mode == "exact"
                                 else "ChannelQuantizedTensor"}
        layouts_ok = layouts_ok and not gpu.language_model.fused_decode
        with env_vars(MLX_VLM_TPU_KV_SCHEME=scheme):
            replay_ok = replay_matches_eager(gpu, label, kv_bits)
        del gpu
        torch.cuda.empty_cache()
        want = {k: 0 for k in NOT_ON_QUANT_PATH + ("qmatmul_int4",
                                                   "qmatmul_int8")}
        if counter:
            want[counter] = QUANT_STEPS * (7 * n_layers + 1)
        counts_ok = all(counts[k] == v for k, v in want.items())
        ok, err, tol, n_margin = parity_rule(ref, got)
        print(f"  {label} ({'/'.join(sorted(layouts))}) vs the CPU in "
              f"{ref_dtype}: max|cuda - cpu| = {err:.4e}, tol {tol:.4e}; "
              f"argmax checked on {n_margin}/{QUANT_STEPS} steps; launches "
              f"{ {k: counts[k] for k in want} } (want {want}); "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{'ok' if ok and counts_ok and layouts_ok else 'MISMATCH'}",
              flush=True)
        all_ok = all_ok and ok and counts_ok and layouts_ok and replay_ok
    return all_ok


# ------------------------------------------------------------ phase 4


# The kernel each quantized request's decode attention runs, once per layer
# and step: {kv_bits, MLX_VLM_TPU_TQ_SCHEME} -> counter name.
KV_KERNEL = {(3.5, None): "tq_kv_attention", (3.5, "split"):
             "tq_kv_attention_split", (4, None): "int4_kv_attention"}


def prefill_chunks(S: int, max_tokens: int, block_size: int = 32) -> int:
    """Prefill chunks of a request, by generate_step's rule for a cache of
    round_up(S + max_tokens + min(block_size, max_tokens) + 1, 256) rows
    (`suffix_chunks` at prefix 0)."""
    block = max(1, min(block_size, max_tokens))
    return suffix_chunks(0, S, -(-(S + max_tokens + block + 1) // 256)
                         * 256)[0]


def suffix_chunks(prefix: int, S: int, capacity: int,
                  step: int = 512) -> tuple:
    """generate_step's and the batch admission's prefill of [prefix, S)
    into a cache of `capacity` rows: the chunk is the rows to prefill
    rounded up to 256, at most `step`, halved while the padded rows
    overflow the cache behind the prefix.  Returns (chunks, chunk rows)."""
    suffix = S - prefix
    step = min(step, -(-suffix // 256) * 256)
    while prefix + -(-suffix // step) * step > capacity and step > 64:
        step = max(64, step // 2)
    return -(-suffix // step), step


# `python3 chip_smoke.py --profile`: phase 4 also traces each request's
# captured step under torch.profiler (a diagnostic; no check reads it)
PROFILE = "--profile" in sys.argv[1:]


def print_profile(run, what: str = "replays") -> None:
    """Prints the kernels that a torch.profiler trace of three calls of
    `run` (a captured step's replay, or an eager step) sees: the trace's
    kernel ms and launches a step and the six longest kernels by device
    time, or that it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, us / 3e3, e.count / 3))
    rows.sort(key=lambda r: -r[1])
    top = "; ".join(f"{k[:48]} {t:.4f} ms x{n:g}" for k, t, n in rows[:6])
    print(f"    torch.profiler over 3 {what}: " + (
        f"{sum(r[1] for r in rows):.4f} ms of kernels a step in "
        f"{sum(r[2] for r in rows):g} launches, most: {top}"
        if rows else "no device time seen"), flush=True)


def run_request(model, proc, cfg, name: str, route: str, text: str, image,
                n_img: int, max_tokens: int, kv_bits, env: dict,
                video=None, prompt=None) -> tuple:
    """One greedy request through stream_generate with `env` set, the
    kernels' launch counters set to 0 just before it and read just after;
    prints its metrics (with the decode loop's first-step and capture
    seconds, graph replays and host fetches, which must be one per block
    and one for the first token) and returns (launch counts, generated
    tokens, prompt tokens, decode steps run).  `video` (frames at
    VIDEO_FPS) goes to stream_generate with `prompt`, the chat prompt that
    holds its token."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template, stream_generate
    from mlx_vlm_tpu_torch.generate import ar

    if prompt is None:
        prompt = apply_chat_template(proc, cfg, text, num_images=n_img)
    torch.cuda.reset_peak_memory_stats()
    times, last = [], None
    with env_vars(**env):
        reset_counts()
        tic = time.perf_counter()
        for res in stream_generate(model, proc, prompt, image=image,
                                   video=video, fps=VIDEO_FPS,
                                   max_tokens=max_tokens, kv_bits=kv_bits):
            times.append(time.perf_counter())
            if not np.all(np.isfinite(res.logprobs)):
                fail(f"{name}: non-finite logits at token {len(times)}")
            last = res
        counts = read_counts()
    if last is None:
        fail(f"{name}: no tokens")
    decode = ar.last_decode
    stats = decode.stats
    n = last.generation_tokens
    if not (n == max_tokens or last.finish_reason == "stop"):
        fail(f"{name}: {n} tokens, finish_reason {last.finish_reason}")
    block = min(32, max_tokens)
    steps, blocks = stats["steps"], stats["blocks"]
    # every step runs n - 1 times unless the request stopped on EOS, when
    # the block in flight and the one after may have run past it
    if not (steps == n - 1 or (last.finish_reason == "stop"
                               and n - 1 <= steps <= n - 1 + 2 * block)):
        fail(f"{name}: {steps} decode steps ran for {n} tokens")
    if n > 1 and not (stats["replays"] == steps - 1
                      and stats["fetches"] == blocks + 1
                      and blocks == -(-steps // block)):
        fail(f"{name}: decode counts {stats}, want one capture, "
             f"{steps - 1} replays and one fetch per block of {block} and "
             f"one for the first token")
    ttft = times[0] - tic
    tps = (n - 1) / (times[-1] - times[0]) if n > 1 else 0.0
    ms_token = 1e3 * (times[-1] - times[0]) / max(n - 1, 1)
    # tokens 2 .. n - 1 are replays: the first decode step (waited for)
    # and the capture taken out of the time, the rest over n - 2 replays
    first_s, capture_s = stats["first_s"], stats["capture_s"]
    ms_replayed = 1e3 * (times[-1] - times[0] - first_s - capture_s
                         ) / max(n - 2, 1)
    print(f"  {name} ({route} decode): prompt {last.prompt_tokens} "
          f"tokens, TTFT {ttft:.4f} s, decode {tps:.2f} tok/s over {n} "
          f"tokens: {ms_token:.4f} ms per token, {ms_replayed:.4f} ms per "
          f"replayed token (first step {first_s:.4f} s and capture "
          f"{capture_s:.4f} s taken out, over {max(n - 2, 1)} replays); "
          f"{steps} decode steps ({stats['replays']} replays) in {blocks} "
          f"blocks of {block} under sync debug mode \"error\", "
          f"{stats['fetches']} host fetches; peak "
          f"{last.peak_memory:.2f} GiB, finish_reason "
          f"{last.finish_reason}; launches {counts}", flush=True)
    if decode.graph is not None:
        # the captured step replayed alone, 10 times between CUDA events
        # (the cursor moves on by 10, inside the capacity's slack of
        # block_size + 1 rows; replayed directly, so no launch is counted)
        dev_ms = _events_ms(decode.graph.graph.replay, 10)
        print(f"    replayed step on the device: {dev_ms:.4f} ms (CUDA "
              f"events over 10 replays; {dev_ms / ms_replayed:.1%} of the "
              f"ms per replayed token)", flush=True)
        if PROFILE:
            print_profile(decode.graph.graph.replay)
    return counts, n, last.prompt_tokens, steps


# Requests (i) and (j): five prompts into four slots (the fifth waits for a
# free slot): three text prompts of different lengths and two images
# (text, image size or None)
BATCH_PROMPTS = (
    ("Write a short story about a lighthouse.", None),
    ("Describe this image in detail.", 448),
    ("List the planets of the solar system in order, and give one fact "
     "about each of them.", None),
    ("What is in this image?", 224),
    ("Hi.", None),
)
# (batch_generate's generator decodes in blocks of its default 8 steps)
BATCH_MAX_TOKENS, BATCH_STEP_BLOCK, BATCH_NUM_SLOTS = 32, 8, 4


def batch_prompts(proc, cfg, images: bool = True) -> tuple:
    """BATCH_PROMPTS as batch_generate takes them: (prompts, images); with
    `images` False (a text-only model) their texts alone."""
    from mlx_vlm_tpu_torch import apply_chat_template

    sizes = [size if images else None for _, size in BATCH_PROMPTS]
    return ([apply_chat_template(proc, cfg, text,
                                 num_images=int(size is not None))
             for (text, _), size in zip(BATCH_PROMPTS, sizes)],
            [None if size is None else _image(size) for size in sizes])


def batch_prompt_requests(model, proc, cfg) -> tuple:
    """BATCH_PROMPTS made into BatchRequests as batch_generate makes them
    (greedy, BATCH_MAX_TOKENS each, the model's and processor's EOS ids).
    Returns (requests, each one's prepare_inputs arrays, the EOS ids)."""
    from mlx_vlm_tpu_torch.generate.batch import BatchRequest
    from mlx_vlm_tpu_torch.generate.common import embed_prompt
    from mlx_vlm_tpu_torch.generate.dispatch import _get_eos_ids
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    eos = tuple(_get_eos_ids(model, proc))
    reqs, arrays = [], []
    for uid, (prompt, image) in enumerate(zip(*batch_prompts(proc, cfg))):
        inputs = prepare_inputs(proc, prompt, images=image)
        embeds, pos, deltas = embed_prompt(model, inputs)
        reqs.append(BatchRequest(
            uid=uid, inputs_embeds=embeds, max_tokens=BATCH_MAX_TOKENS,
            position_ids=pos, rope_delta=int(deltas[0, 0]), eos_ids=eos))
        arrays.append(inputs)
    return reqs, arrays, eos


def report_batch(name: str, st: dict, counts: dict, tokens: str, n_gen: int,
                 prompt_tokens: int, wall: float, kv_bits, n_layers: int,
                 total: dict, want=None) -> float:
    """Checks a batch request's generator counters (one capture, a replay
    per step after the first, a fetch per block and admission) and holds
    each kernel's launches to the steps and prefill chunks that ran (K2 =
    197 a step + one head per prefill chunk holding a row's last token, K1
    = 196 a chunk, K6 = 28 a step at kv_bits 4, the rest 0; or `want`,
    where the caller gives the launches); prints its metrics.  Returns the
    host ms per replayed batch step."""
    import torch

    if not 0 < n_gen <= len(BATCH_PROMPTS) * BATCH_MAX_TOKENS:
        fail(f"{name}: {n_gen} tokens generated")
    if not (st["captures"] == 1 and st["replays"] == st["steps"] - 1
            and st["steps"] == BATCH_STEP_BLOCK * st["blocks"]
            and st["fetches"] == st["blocks"] + st["admissions"]):
        fail(f"{name}: decode counts {st}, want one capture, a replay per "
             f"step after the first and a fetch per block and admission")
    ms_replayed = 1e3 * (st["decode_s"] - st["first_s"] - st["capture_s"]
                         ) / max(st["replays"], 1)
    print(f"  {name}: {len(BATCH_PROMPTS)} prompts ({prompt_tokens} tokens) "
          f"in {BATCH_NUM_SLOTS} slots: {n_gen} tokens{tokens} in "
          f"{wall:.4f} s, {n_gen / wall:.2f} tok/s aggregate; "
          f"{st['steps']} batch steps in {st['blocks']} blocks of "
          f"{BATCH_STEP_BLOCK}: {st['captures']} capture, {st['replays']} "
          f"replays, {st['fetches']} fetches ({st['blocks']} blocks + "
          f"{st['admissions']} admissions), first step {st['first_s']:.4f} s, "
          f"capture {st['capture_s']:.4f} s, {ms_replayed:.4f} ms per "
          f"replayed batch step ({st['decode_s']:.4f} s of blocks); "
          f"{st['prefill_chunks']} prefill chunks; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{counts}", flush=True)
    if want is None:
        want = {k: 0 for k in counts}
        want["int4_matvec"] = ((7 * n_layers + 1) * st["steps"]
                               + st["prefill_heads"])
        want["int4_matmul"] = 7 * n_layers * st["prefill_chunks"]
        if kv_bits == 4:
            want["int4_kv_attention"] = n_layers * st["steps"]
    expect(name, counts, want, total)
    return ms_replayed


def run_batch_generate(model, proc, cfg, total: dict,
                       name: str = "(i) batch_generate",
                       with_images: bool = True, want=None) -> list:
    """Request (i): BATCH_PROMPTS (their texts alone without `with_images`)
    through batch_generate (greedy, bf16 batch cache), the kernels' launch
    counters set to 0 just before it and read just after, and held to
    report_batch's launches or to want(counts, generator stats).  Returns
    its texts."""
    import torch

    from mlx_vlm_tpu_torch import batch_generate

    prompts, images = batch_prompts(proc, cfg, with_images)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = batch_generate(model, proc, prompts, images=images,
                         max_tokens=BATCH_MAX_TOKENS,
                         num_slots=BATCH_NUM_SLOTS)
    counts = read_counts()
    if len(res.texts) != len(prompts):
        fail(f"{name}: {len(res.texts)} texts for {len(prompts)} prompts")
    st = res.generator_stats
    report_batch(name, st, counts, "", res.stats["generation_tokens"],
                 res.stats["prompt_tokens"], res.stats["wall_s"], None,
                 model.language_model.args.num_hidden_layers, total,
                 want=None if want is None else want(counts, st))
    return res.texts


def run_batch_generator(model, proc, cfg, total: dict) -> None:
    """Request (j): BATCH_PROMPTS through BatchGenerator(kv_bits=4), its
    requests made as batch_generate makes them, timed from preprocessing
    to the last block as (i) is, the counters set to 0 just before it and
    read just after; then its captured batch step replayed alone between
    CUDA events (and profiled with --profile)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tic = time.perf_counter()
    reqs, arrays, _ = batch_prompt_requests(model, proc, cfg)
    out, gen = drive_batch(model, reqs, num_slots=BATCH_NUM_SLOTS,
                           block_size=BATCH_STEP_BLOCK, kv_bits=4)
    wall = time.perf_counter() - tic
    counts = read_counts()
    lens = [len(out[r.uid]) for r in reqs]
    if not all(np.isfinite(lp) for v in out.values() for _, lp in v):
        fail("(j): non-finite logprobs")
    if not all(0 < n <= BATCH_MAX_TOKENS for n in lens):
        fail(f"(j): tokens {lens}")
    ms_replayed = report_batch(
        "(j) as (i), BatchGenerator(kv_bits=4)", gen.stats, counts,
        f" {lens}", sum(lens), sum(a["input_ids"].shape[1] for a in arrays),
        wall, 4, model.language_model.args.num_hidden_layers, total)
    # the captured batch step replayed alone, 10 times between CUDA events
    # (every slot is free: idle rows write at their parked cursor 0)
    dev_ms = _events_ms(gen.decode.graph.graph.replay, 10)
    print(f"    replayed batch step on the device: {dev_ms:.4f} ms (CUDA "
          f"events over 10 replays; {dev_ms / ms_replayed:.1%} of the ms per "
          f"replayed batch step)", flush=True)
    if PROFILE:
        print_profile(gen.decode.graph.graph.replay)


def batch_vs_single(model, proc, cfg, texts: list) -> None:
    """Each row of request (i) against its prompt run alone.  The five
    requests run again through a BatchGenerator as batch_generate runs
    them, every step eager so that a Recorder keeps each step's logits;
    its texts must equal (i)'s, token for token (`proc` names every id;
    replayed steps are bit-identical to eager ones, phase 3).  Each row's prompt then runs alone on the single-stream
    path (a B = 1 cache, MLX_VLM_TPU_FUSED_DECODE=0: K2 at M = 1), teacher-
    forced with the row's tokens, and the row's logits are held to the
    single run's by the parity rule at every step."""
    from mlx_vlm_tpu_torch.generate.batch import detokenize
    from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode

    t0 = time.perf_counter()
    os.environ["MLX_VLM_TPU_FUSED_DECODE"] = "0"
    decide_fused_decode(model)
    try:
        reqs, arrays, eos = batch_prompt_requests(model, proc, cfg)
        rec = Recorder([r.uid for r in reqs])
        out, gen = drive_batch(model, reqs, graph=False, recorder=rec,
                               num_slots=BATCH_NUM_SLOTS,
                               block_size=BATCH_STEP_BLOCK)
        eager = [detokenize(proc, [t for t, _ in out[r.uid]], eos)
                 for r in reqs]
        print(f"  (i) again with eager steps: tokens "
              f"{[len(out[r.uid]) for r in reqs]}, texts (every token "
              f"named) equal to (i)'s: {eager == texts}", flush=True)
        if eager != texts:
            fail("(i)'s texts differ from the same batch with eager steps")
        rows = per_request(rec.results(),
                           {u: len(v) for u, v in out.items()})
        for req, inputs in zip(reqs, arrays):
            toks = [t for t, _ in out[req.uid]]
            single, _ = teacher_forced_logits(model, inputs,
                                              forced=toks[:-1],
                                              n_steps=len(toks))
            ok, err, tol, n_margin = parity_rule(single, rows[req.uid])
            print(f"  (i) row {req.uid} vs its prompt alone (per-linear, K2 "
                  f"at M = 1), teacher-forced with the row's {len(toks)} "
                  f"tokens: max|batch - alone| = {err:.4e}, tol {tol:.4e} "
                  f"over all {len(toks)} steps; argmax checked on "
                  f"{n_margin} steps {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                fail(f"(i) row {req.uid} differs from its single-stream run")
        print(f"  (i) against its prompts alone: {time.perf_counter() - t0:.1f}"
              f" s", flush=True)
        if PROFILE:  # (i)'s batch step, run eagerly: the same kernels
            print_profile(gen.decode.step, "eager steps of (i)'s batch "
                          "(one more copy: the recorder's)")
    finally:
        del os.environ["MLX_VLM_TPU_FUSED_DECODE"]
        decide_fused_decode(model)


# ------------------------------------------------------------ phase 4, server


# The server part: (k1)-(k6) sent at once to one server (4 slots of 4096
# rows, blocks of 8 steps) on (a)-(f)'s model: (label, route, user text,
# image size or None, streamed, logprobs, response_format, max_tokens)
SERVER_SLOTS, SERVER_CAPACITY, SERVER_BLOCK = 4, 4096, 8
JSON_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "age": {"type": "integer"}},
    "required": ["name"], "additionalProperties": False}
SERVER_REQUESTS = (
    ("(k1)", "chat", "Write a short story about a lighthouse.", None, False,
     True, None, 32),
    ("(k2)", "chat", "List the planets of the solar system in order.", None,
     True, False, None, 32),
    ("(k3)", "chat", "Describe this image in detail.", 448, False, False,
     None, 32),
    ("(k4)", "messages", "Name three colors.", None, False, False, None, 32),
    ("(k5)", "chat", "Hi.", None, False, False, None, 32),
    ("(k6)", "chat", "Give a name and an age.", None, False, False,
     {"type": "json_schema", "json_schema": {"schema": JSON_SCHEMA}}, 24),
)
# then a second server with kv_bits=4: two text chats at once
KV4_REQUESTS = (
    ("(k7)", "chat", "Write a haiku about the sea.", None, False, False,
     None, 16),
    ("(k8)", "chat", "What is the capital of France?", None, False, False,
     None, 16),
)
# decode steps the recorder keeps per server (the first server runs about
# 70: five requests of 32 tokens in four slots, blocks of 8)
RECORD_STEPS = 160


class ServerRecorder:
    """The batched sampler of a server's BatchGenerator, recording what it
    is given without a host read: each decode step's logits [B, V] and
    tokens [B] go into device rings at a device counter (the step is
    captured once and replayed, so the recording is part of the graph),
    and the slot owners of each dispatched block are kept on the host; each
    admission's first-token logits are kept with the uids of its requests
    (through the generator's `_first`) and its layout (`admitted`: uid ->
    (its row, the uids of its admission's rows, (rows, padded length,
    chunk)), through the generator's `_prefill`).  Returns the real
    sampler's tokens."""

    def __init__(self, vocab: int, dev):
        import torch

        from mlx_vlm_tpu_torch.core.sampling import make_batched_sampler

        self.real = make_batched_sampler()
        self.logits = torch.zeros((RECORD_STEPS, SERVER_SLOTS, vocab),
                                  dtype=torch.float32, device=dev)
        self.tokens = torch.zeros((RECORD_STEPS, SERVER_SLOTS),
                                  dtype=torch.int64, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.blocks, self.admissions, self.uids = [], [], None
        self.admitted, self.layout, self.gen = {}, None, None

    def attach(self, gen) -> None:
        """Hook the generator's admissions and block dispatches."""
        prefill, first, dispatch = gen._prefill, gen._first, gen.decode.dispatch

        def prefill_hook(cache, embeds, pos, last_idx, step):
            self.layout = (embeds.shape[0], embeds.shape[1], step)
            return prefill(cache, embeds, pos, last_idx, step)

        def first_hook(logits, reqs):
            self.uids = [r.uid for r in reqs]
            for i, u in enumerate(self.uids):
                self.admitted[u] = (i, self.uids, self.layout)
            return first(logits, reqs)

        def dispatch_hook(n):
            self.blocks.append((n, [
                s.req.uid if s is not None and gen.active[i] else None
                for i, s in enumerate(gen.slots)]))
            return dispatch(n)

        gen._prefill, gen._first = prefill_hook, first_hook
        gen.decode.dispatch = dispatch_hook
        self.gen = gen

    def __call__(self, logits, params, generator):
        toks = self.real(logits, params, generator)
        if params is self.gen.params:  # a decode step over the slots
            at = self.step.reshape(1)
            self.logits.index_copy_(0, at, logits.float()[None])
            self.tokens.index_copy_(0, at, toks[None])
            self.step.add_(1)
        else:
            self.admissions.append((logits.float().clone(), toks.clone(),
                                    list(self.uids)))
        return toks

    def rows(self) -> dict:
        """{uid: (logits [n, V] numpy, tokens [n])}: each request's
        admission row, then its row of every step it held a slot in."""
        import torch

        steps = int(self.step)
        if steps > RECORD_STEPS:
            fail(f"the server ran {steps} steps; the recorder keeps "
                 f"{RECORD_STEPS}")
        out: dict = {}
        for logits, toks, uids in self.admissions:
            for r, u in enumerate(uids):
                out[u] = ([logits[r]], [int(toks[r])])
        s = 0
        for n, owners in self.blocks:
            for r, u in enumerate(owners):
                if u is not None:
                    out[u][0].extend(self.logits[s:s + n, r])
                    out[u][1].extend(self.tokens[s:s + n, r].tolist())
            s += n
        if s != steps:
            fail(f"the server's blocks hold {s} steps, its rings {steps}")
        return {u: (torch.stack(lg).cpu().numpy(), t)
                for u, (lg, t) in out.items()}


def _http(url: str, path: str, body=None) -> tuple:
    """(status, content type, body bytes) of one request to the server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _png_data_uri(arr) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def server_body(req) -> dict:
    """A request's HTTP body (the image as a PNG data URI)."""
    label, route, text, size, stream, logprobs, fmt, n = req
    content = text
    if size is not None:
        content = [{"type": "text", "text": text}]
        if route == "chat":
            content.append({"type": "image_url", "image_url": {
                "url": _png_data_uri(_image(size))}})
    body = {"messages": [{"role": "user", "content": content}],
            "max_tokens": n, "stream": stream}
    if logprobs:
        body["logprobs"] = True
    if fmt is not None:
        body["response_format"] = fmt
    return body


def client(url: str, req, generator, http_image: bool, proc, cfg) -> dict:
    """Send one request and read its whole answer: {status, errors, text,
    finish, the usage's completion tokens, logprobs where asked, whether
    an SSE stream ended in [DONE], seconds}."""
    label, route, text, size, stream, logprobs, fmt, n = req
    t0 = time.perf_counter()
    if size is not None and not http_image:
        # no PIL on this machine: the image request enters at the engine,
        # with a uint8 array, as normalize_chat_request would build it
        from mlx_vlm_tpu_torch import apply_chat_template
        from mlx_vlm_tpu_torch.server.engine import GenerationArguments

        prompt = apply_chat_template(
            proc, cfg, [{"role": "user", "content": [
                {"type": "text", "text": text}, {"type": "image"}]}],
            add_generation_prompt=True, num_images=1)
        toks = list(generator.generate(GenerationArguments(
            prompt=prompt, images=[_image(size)], max_tokens=n)))
        errors = [t.error for t in toks if t.error]
        return {"status": 500 if errors else 200, "errors": errors,
                "text": "".join(t.text for t in toks),
                "finish": toks[-1].finish_reason,
                "completion": sum(t.token is not None for t in toks),
                "done": True,
                "s": time.perf_counter() - t0}
    path = "/v1/messages" if route == "messages" else "/v1/chat/completions"
    status, _, raw = _http(url, path, server_body(req))
    out = {"status": status, "s": time.perf_counter() - t0, "done": True,
           "errors": []}
    if status != 200:
        out["errors"] = [raw.decode(errors="replace")[:300]]
        return out
    if stream:
        events = [line[6:] for line in raw.decode().splitlines()
                  if line.startswith("data: ")]
        out["done"] = events[-1:] == ["[DONE]"]
        chunks = [json.loads(e) for e in events if e != "[DONE]"]
        out["errors"] = [c["error"] for c in chunks if "error" in c]
        if out["errors"]:
            return out
        out["text"] = "".join(c["choices"][0]["delta"].get("content", "")
                              for c in chunks)
        out["finish"] = chunks[-1]["choices"][0]["finish_reason"]
        out["completion"] = chunks[-1]["usage"]["completion_tokens"]
        return out
    answer = json.loads(raw)
    if route == "messages":
        out["text"] = answer["content"][0]["text"]
        out["finish"] = answer["stop_reason"]
        out["completion"] = answer["usage"]["output_tokens"]
        return out
    choice = answer["choices"][0]
    out["text"] = choice["message"]["content"]
    out["finish"] = choice["finish_reason"]
    out["completion"] = answer["usage"]["completion_tokens"]
    if logprobs:
        out["logprobs"] = [t["logprob"] for t in choice["logprobs"]["content"]]
    return out


def serve_requests(model, proc, cfg, requests, kv_bits) -> tuple:
    """One server (create_server on the loaded model, served from a thread)
    answering `requests`, sent at once from client threads after /health,
    /v1/models and /metrics were checked; the kernels' launch counters set
    to 0 just before the requests and read once every answer is in.  The
    server and its generator are shut down before it returns.  Returns
    (answers by label, each label's GenerationArguments, the batch's
    ServerRecorder, the constrained request's (logits, token) picks, the
    launch counts, the generator's stats, /metrics after the requests,
    the requests' seconds, the constrained request's DecodeBlocks,
    whether the image went over HTTP)."""
    import socket
    import threading

    import torch

    from mlx_vlm_tpu_torch import structured
    from mlx_vlm_tpu_torch.generate import ar, batch
    from mlx_vlm_tpu_torch.server.app import create_server

    vocab = model.language_model.args.vocab_size
    rec = ServerRecorder(vocab, model.device)
    constrained = []  # (logits, token) of each automaton pick
    real_make, real_constrained = (batch.make_batched_sampler,
                                   structured.make_constrained_sampler)

    def recording_constrained(proc_):
        sampler = real_constrained(proc_)

        def rec_sampler(logits, generator=None):
            toks = sampler(logits, generator)
            constrained.append((logits.float()[0].cpu().numpy(),
                                int(toks[0])))
            return toks

        rec_sampler.on_host = True
        return rec_sampler

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    batch.make_batched_sampler = lambda: rec
    try:
        httpd = create_server(model, proc, model_name="qwen2-vl-7b-random",
                              host="127.0.0.1", port=port,
                              num_slots=SERVER_SLOTS,
                              capacity=SERVER_CAPACITY,
                              block_size=SERVER_BLOCK, kv_bits=kv_bits)
    finally:
        batch.make_batched_sampler = real_make
    generator = httpd.state.generator
    rec.attach(generator.batch)
    seen_args = []
    real_generate = generator.generate

    def logging_generate(args):
        seen_args.append(args)
        return real_generate(args)

    generator.generate = logging_generate
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{port}"
    http_image = importlib.util.find_spec("PIL") is not None
    try:
        for path, key in (("/health", "status"), ("/v1/models", "data"),
                          ("/metrics", "requests_total")):
            status, _, raw = _http(url, path)
            if status != 200 or key not in json.loads(raw):
                fail(f"server: GET {path} answered {status}: {raw[:200]}")
        structured.make_constrained_sampler = recording_constrained
        answers = {}
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(
            target=lambda r=r: answers.__setitem__(r[0], client(
                url, r, generator, http_image, proc, cfg)))
            for r in requests]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = read_counts()
        if any(t.is_alive() for t in threads):
            fail("server: a request did not finish in 600 s")
        status, _, raw = _http(url, "/metrics")
        metrics = json.loads(raw)
    finally:
        structured.make_constrained_sampler = real_constrained
        httpd.shutdown()
        generator.shutdown()
        server.join(timeout=30)
    stats = dict(generator.batch.stats)
    decode = ar.last_decode
    if generator._thread.is_alive():
        fail("server: the generator's owner thread did not stop")
    labels = {}
    for args in seen_args:
        label = next(r[0] for r in requests if r[2] in args.prompt)
        labels[label] = args
    del httpd, generator
    torch.cuda.empty_cache()
    return (answers, labels, rec, constrained, counts, stats, metrics, wall,
            decode, http_image)


def served_text(proc, toks: list, eos) -> str:
    """What the engine streams for `toks`: each token's segment of a
    detokenizer that skips special tokens, and its tail unless an EOS
    ended the answer."""
    from mlx_vlm_tpu_torch.utils.tokenizer import make_detokenizer

    detok = make_detokenizer(proc.tokenizer, skip_special_tokens=True)
    text = ""
    for t in toks:
        if t in eos:
            return text
        detok.add_token(t)
        text += detok.last_segment()
    return text + detok.finalize()


def check_json_answer(text: str) -> None:
    """(k6)'s content: one JSON object satisfying JSON_SCHEMA."""
    from mlx_vlm_tpu_torch.structured import schema_complete

    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        fail(f"(k6): content is not JSON: {text!r}")
    ok = (isinstance(obj, dict) and set(obj) <= {"name", "age"}
          and isinstance(obj.get("name"), str)
          and type(obj.get("age", 0)) is int
          and schema_complete(text, JSON_SCHEMA))
    print(f"  (k6) content {text!r}: JSON object satisfying the schema "
          f"{ok}", flush=True)
    if not ok:
        fail(f"(k6): {text!r} does not satisfy the schema")


def unpadded_layout_effect(model, inputs: dict, toks: list, kv_bits,
                           ref: np.ndarray, single) -> None:
    """Print what the prefill's layout does to a 4-bit cache: the prompt
    prefilled in one unpadded chunk (teacher_forced_logits' layout) against
    the admission's layout (`ref`, its one-row cache `single`): the share
    of the prompt's 4-bit codes that differ after the prefill, and the
    logits' distance at the prefill and over the teacher-forced steps.  A
    measurement, not a check."""
    from mlx_vlm_tpu_torch.core.cache import cache_buffers

    cache, first, delta = prefill_unpadded(model, inputs, len(toks), kv_bits)
    S = inputs["input_ids"].shape[1]
    flips, total = code_flips(cache_buffers(cache), cache_buffers(single), 0,
                              S)
    got, _ = forced_steps(model, cache, first, delta, toks[:-1], len(toks))
    print(f"    the same prompt prefilled in one unpadded chunk of {S} rows "
          f"instead: {flips} of {total} 4-bit K/V codes differ "
          f"({100 * flips / total:.4f}%), logits at the prefill "
          f"{float(np.abs(got[0] - ref[0]).max()):.4e} and over the "
          f"{len(toks)} steps {float(np.abs(got - ref).max()):.4e} away "
          f"(the layout's effect, not a check)", flush=True)


def run_server(model, cfg, total: dict) -> None:
    """The server part: (k1)-(k6) at once to a server on the loaded model,
    then (k7)-(k8) to one with kv_bits=4 (K6 on per-row cursors).  Every
    answer must be 200 and well formed (an SSE stream ends in [DONE]), its
    usage must count the tokens it received, and its text must be its
    tokens' text; (k6)'s content must parse and satisfy JSON_SCHEMA.  The
    generator must capture its step once; the launches are held to what
    ran (K1 = 196 a prefill chunk, K2 = 197 a batch step + one head per
    chunk holding a prompt's last token, K3 = (k6)'s decode steps, all
    eager, one a recorded pick after the first, K6 = 28 a batch step in the
    kv_bits=4 server).  Then, with no server running, each answer's logits
    are held at every step by the parity rule to its prompt run alone on
    the single stream, teacher-forced with the answer's tokens: the bf16
    rows on the per-linear route (K2 at M = 1, as (i)'s rows are), (k6) on
    the fused route (K3), and the kv_bits=4 rows with their prompts
    prefilled as their admission prefilled them (admission_layout_logits:
    a 4-bit code flips where bf16 K/V round otherwise, so the prefill's
    layout moves the logits; the same prompt in one unpadded chunk is
    printed beside it, with the codes that differ, as that layout's
    effect)."""
    from mlx_vlm_tpu_torch.generate.common import embed_prompt
    from mlx_vlm_tpu_torch.generate.dispatch import _get_eos_ids
    from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    t_part = time.perf_counter()
    proc = _processor()
    eos = tuple(_get_eos_ids(model, proc))
    n_layers = model.language_model.args.num_hidden_layers
    held = []  # (label, logits [n, V], tokens, inputs, kv_bits, fused,
    #            the admission: (row, uids, layout) or None)
    inputs_by_uid = {}
    for requests, kv_bits in ((SERVER_REQUESTS, None), (KV4_REQUESTS, 4)):
        name = "server" if kv_bits is None else "server, kv_bits=4"
        (answers, labels, rec, constrained, counts, st, metrics, wall,
         decode, http_image) = serve_requests(model, proc, cfg, requests,
                                              kv_bits)
        envs = {e.get("request_id"): e for e in metrics["recent"]}
        rows = rec.rows()
        n_total, k6_chunks, k6_steps = 0, 0, 0
        for req in requests:
            label, route, text, size, stream, logprobs, fmt, max_tokens = req
            ans, args = answers.get(label), labels.get(label)
            if ans is None or args is None or ans["status"] != 200 \
                    or ans["errors"] or not ans["done"]:
                fail(f"{name} {label}: {ans}")
            env = envs[args.request_id]
            n = env["generation_tokens"]
            inputs = prepare_inputs(proc, args.prompt,
                                    images=args.images or None)
            inputs_by_uid[args.request_id] = inputs
            S = inputs["input_ids"].shape[1]
            if fmt is not None:
                picks = constrained[:n]
                logits = np.stack([lg for lg, _ in picks])
                toks = [t for _, t in picks]
                check_json_answer(ans["text"])
                k6_chunks = prefill_chunks(S, max_tokens, block_size=1)
                k6_steps = decode.stats["steps"]
                # each pick after the prefill's is one decode step; the
                # loop may run one step past the answer's last token
                if not (k6_steps == len(constrained) - 1
                        and n <= len(constrained) <= n + (n < max_tokens)):
                    fail(f"{label}: {k6_steps} decode steps for "
                         f"{len(constrained)} recorded picks and {n} "
                         f"tokens in the answer")
                if (decode.use_graph or decode.graph is not None
                        or decode.stats["replays"] or not decode.host_sampler):
                    fail(f"{label}: the constrained steps were not all "
                         f"eager: {decode.stats}")
            else:
                logits, toks = rows[args.request_id]
                logits, toks = logits[:n], toks[:n]
                if ans["text"] != served_text(proc, toks, eos):
                    fail(f"{name} {label}: the answer's text is not its "
                         f"tokens' text")
            ended_eos = bool(toks) and toks[-1] in eos
            if len(toks) != n or ans["completion"] != n - ended_eos:
                fail(f"{name} {label}: {ans['completion']} tokens in the "
                     f"usage, {n} generated, {len(toks)} recorded")
            if not (n == max_tokens or ended_eos or fmt is not None):
                fail(f"{name} {label}: {n} of {max_tokens} tokens, finish "
                     f"{ans['finish']}")
            if logprobs:
                lse = np.log(np.exp(logits - logits.max(-1, keepdims=True))
                             .sum(-1)) + logits.max(-1)
                want = [logits[i, t] - lse[i] for i, t in enumerate(toks)]
                got = np.asarray(ans["logprobs"])
                if not (got[0] == 0.0 and np.allclose(
                        got[1:], want[1:len(got)], atol=1e-3)):
                    fail(f"{name} {label}: served logprobs {got} differ from "
                         f"the recorded logits' {want}")
            n_total += ans["completion"]
            print(f"  {name} {label} ({route}{', streamed' if stream else ''}"
                  f"{', image' if size else ''}"
                  f"{', ' + fmt['type'] if fmt else ''}): prompt {S} tokens,"
                  f" {ans['completion']} tokens, finish {ans['finish']}, "
                  f"{ans['s']:.4f} s; /metrics: ttft_s {env['ttft_s']:.4f}, "
                  f"generation_tps {env['generation_tps']:.2f}", flush=True)
            held.append((f"{name} {label}", logits, toks, inputs, kv_bits,
                         fmt is not None, rec.admitted.get(args.request_id)))
        steps = st["steps"]
        if not (st["captures"] == 1 and st["replays"] == steps - 1
                and steps == SERVER_BLOCK * st["blocks"]
                and st["fetches"] == st["blocks"] + st["admissions"]):
            fail(f"{name}: generator counts {st}, want one capture, a replay "
                 f"per step after the first and a fetch per block and "
                 f"admission")
        ms_replayed = 1e3 * (st["decode_s"] - st["first_s"] - st["capture_s"]
                             ) / max(st["replays"], 1)
        print(f"  {name}: {len(requests)} requests at once (image "
              f"{'over HTTP' if http_image else 'through the engine: no PIL'}"
              f"), {n_total} tokens in {wall:.4f} s, {n_total / wall:.2f} "
              f"tok/s aggregate; {steps} batch steps in {st['blocks']} blocks "
              f"of {SERVER_BLOCK}: {st['captures']} capture, {st['replays']} "
              f"replays, {st['fetches']} fetches ({st['blocks']} blocks + "
              f"{st['admissions']} admissions), {st['prefill_chunks']} "
              f"prefill chunks, {ms_replayed:.4f} ms per replayed batch step"
              f"{f'; (k6) {k6_steps} eager steps' if kv_bits is None else ''}"
              f"; launches {counts}", flush=True)
        want = {k: 0 for k in counts}
        want["int4_matvec"] = ((7 * n_layers + 1) * steps + st["prefill_heads"]
                               + (1 if kv_bits is None else 0))
        want["int4_matmul"] = 7 * n_layers * (st["prefill_chunks"] + k6_chunks)
        want["fused_decode"] = k6_steps
        if kv_bits == 4:
            want["int4_kv_attention"] = n_layers * steps
        expect(name, counts, want, total)
    # every answer against its prompt alone, no server running
    try:
        for label, logits, toks, inputs, kv_bits, fused, admitted in held:
            os.environ["MLX_VLM_TPU_FUSED_DECODE"] = "1" if fused else "0"
            decide_fused_decode(model)
            route = "K3" if fused else "per-linear, K2 at M = 1"
            if kv_bits:
                row, uids, layout = admitted
                ref, single = admission_layout_logits(
                    model, [embed_prompt(model, inputs_by_uid[u])
                            for u in uids], row, layout, toks[:-1], kv_bits)
                what = (f"on the single stream ({route}, kv_bits {kv_bits}),"
                        f" prefilled as its admission was ({layout[0]} rows "
                        f"of {layout[1]}, chunks of {layout[2]})")
            else:
                ref, _ = teacher_forced_logits(model, inputs,
                                               forced=toks[:-1],
                                               n_steps=len(toks))
                what = f"on the single stream ({route})"
            ok, err, tol, n_margin = parity_rule(ref, logits)
            print(f"  {label} vs its prompt alone {what}, teacher-forced with "
                  f"its {len(toks)} tokens: max|served - alone| = {err:.4e}, "
                  f"tol {tol:.4e}; argmax checked on {n_margin} steps "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"{label} differs from its prompt run alone")
            if kv_bits:
                unpadded_layout_effect(model, inputs, toks, kv_bits, ref,
                                       single)
    finally:
        del os.environ["MLX_VLM_TPU_FUSED_DECODE"]
        decide_fused_decode(model)
    print(f"  server part: {time.perf_counter() - t_part:.1f} s", flush=True)


# ------------------------------------------------------------ phase 4, APC


# (c)'s text (about 8.2k tokens with the template and a 448x448 image)
LONG_TEXT = ("The quick brown fox jumps over the lazy dog. " * 183
             + "Summarize the text and the image.")
# The prefix-caching part, on (a)-(f)'s model: greedy, 16 tokens a request
APC_TOKENS, APC_BLOCK = 16, 16
# (l2)'s new user turn (about 400 tokens), (l3)'s text (sized so that its
# prompt is 40 past a multiple of 256: (l3)'s snapshot then holds (l4)'s
# continuation, see apc_exact) and (l4)'s 64-token follow-up
APC_TURN2 = ("Now compare the image with the text above, and list three "
             "details that the text leaves out. " * 5)[:400]
APC_EXACT_TEXT = "A lighthouse keeper writes a log of ships and weather. "
APC_FOLLOW_UP = (" And what does the keeper write about the storm that came "
                 "in the night?")[:64]
# (m)'s system prompt (about 1,500 tokens) and its two questions
APC_SYSTEM = ("You are a careful assistant for a shipping company. Answer "
              "briefly, name your sources, and never invent numbers. " * 14)
APC_QUESTIONS = ("Which ports do we serve in winter?",
                 "How heavy may one container be?")


class StreamRecorder:
    """A single-stream sampler (generate_step's `sampler(logits,
    generator)`, B = 1) that keeps each call's logits in a device ring at a
    device counter (inside a captured step, so part of the graph; no host
    read) and returns the greedy token, or with `forced` (int64 [n] on
    the device) the forced token of that call."""

    def __init__(self, n: int, vocab: int, dev, forced=None):
        import torch

        self.logits = torch.zeros((n, vocab), dtype=torch.float32, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.forced = forced

    def __call__(self, logits, generator=None):
        at = self.step.reshape(1)
        self.logits.index_copy_(0, at, logits.float())
        tok = (logits.argmax(-1) if self.forced is None
               else self.forced.index_select(0, at))
        self.step.add_(1)
        return tok

    def rows(self, n: int) -> np.ndarray:
        if int(self.step) < n:
            fail(f"the recorder kept {int(self.step)} steps, want {n}")
        return self.logits[:n].cpu().numpy()


def shared_prefix(a: list, b: list) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def timed(obj, name: str, log: list) -> None:
    """Wrap obj.name so that each call's seconds and result go to `log`."""
    real = getattr(obj, name)

    def run(*a, **k):
        t = time.perf_counter()
        out = real(*a, **k)
        log.append((time.perf_counter() - t, out))
        return out

    setattr(obj, name, run)


def pool_bytes(apc) -> int:
    """Host bytes of an APCManager's blocks and exact snapshots' buffers."""
    from mlx_vlm_tpu_torch.core.cache import cache_buffers

    n = sum(b.k.nbytes + b.v.nbytes for b in apc.blocks.values())
    for _, snap, _ in apc._exact.values():
        n += sum(t.numel() * t.element_size() for t in cache_buffers(snap))
    return n


def forcing(model, tokens: list) -> StreamRecorder:
    """A StreamRecorder that returns `tokens`, call by call."""
    import torch

    return StreamRecorder(len(tokens) + 64,
                          model.language_model.args.vocab_size, model.device,
                          forced=torch.tensor(tokens + [0] * 64,
                                              device=model.device))


def apc_turn(model, proc, name: str, prompt: str, image, apc, vc,
             kv_bits=None) -> dict:
    """One greedy request through stream_generate(apc=, vision_cache=) with
    a StreamRecorder for its sampler, the counters set to 0 just before it
    and read just after; checks its tokens and decode counts as
    run_request does.  Returns {tokens, text, logits, counts, ttft, S,
    steps, cache (the request's cache, ar.last_decode.cache)}."""
    import torch

    from mlx_vlm_tpu_torch import stream_generate
    from mlx_vlm_tpu_torch.generate import ar, dispatch

    rec = StreamRecorder(APC_TOKENS + 64, model.language_model.args.vocab_size,
                         model.device)
    real = dispatch.make_sampler
    dispatch.make_sampler = lambda *a, **k: rec
    toks, text, last = [], "", None
    try:
        reset_counts()
        tic = time.perf_counter()
        for res in stream_generate(model, proc, prompt, image=image,
                                   max_tokens=APC_TOKENS, kv_bits=kv_bits,
                                   apc=apc, vision_cache=vc):
            if last is None:
                ttft = time.perf_counter() - tic
            if not np.all(np.isfinite(res.logprobs)):
                fail(f"{name}: non-finite logits")
            toks.append(res.token)
            text += res.text
            last = res
        if last is None:
            fail(f"{name}: no tokens")
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        dispatch.make_sampler = real
    st = ar.last_decode.stats
    n = len(toks)
    if not (n == APC_TOKENS or last.finish_reason == "stop"):
        fail(f"{name}: {n} tokens, finish {last.finish_reason}")
    replays = st["steps"] - 1 if ar.last_decode.use_graph else 0
    if not (st["replays"] == replays
            and st["fetches"] == st["blocks"] + 1):
        fail(f"{name}: decode counts {st}")
    return {"tokens": toks, "text": text, "logits": rec.rows(n),
            "counts": counts, "ttft": ttft, "S": last.prompt_tokens,
            "steps": st["steps"], "cache": ar.last_decode.cache}


def forced_cold(model, inputs: dict, vc, tokens: list, capacity: int,
                kv_bits=None) -> tuple:
    """The prompt of `inputs` cold, without APC, through generate_step with
    `kv_capacity=capacity`, teacher-forced with `tokens` (a forcing
    StreamRecorder): (its logits [n, V], TTFT from prepare_inputs' arrays
    to the first token, its cache)."""
    from mlx_vlm_tpu_torch.generate import ar
    from mlx_vlm_tpu_torch.generate.common import embed_prompt

    rec = forcing(model, tokens)
    tic = time.perf_counter()
    embeds, pos, deltas = embed_prompt(model, inputs, vc)
    ttft = None
    for _ in ar.generate_step(embeds, model, position_ids=pos,
                              rope_deltas=deltas, max_tokens=len(tokens),
                              sampler=rec, kv_bits=kv_bits,
                              kv_capacity=capacity):
        ttft = ttft or time.perf_counter() - tic
    return rec.rows(len(tokens)), ttft, ar.last_decode.cache


def layout_reference(model, inputs: dict, prefix: int, tokens: list,
                     capacity: int) -> np.ndarray:
    """A prompt at kv_bits=4 prefilled as a warm exact-mode request
    prefills it, with no snapshot and no restore: rows [0, prefix) by
    generate_step into a cold cache of `capacity` rows, then the rest by
    generate_step on that cache at `prefix`, teacher-forced with `tokens`.
    Returns its logits [n, V]."""
    from mlx_vlm_tpu_torch.generate import ar
    from mlx_vlm_tpu_torch.generate.common import embed_prompt

    embeds, pos, deltas = embed_prompt(model, inputs)
    held = []
    first = ar.generate_step(embeds[:, :prefix], model,
                             position_ids=pos[:, :, :prefix],
                             rope_deltas=deltas, max_tokens=APC_TOKENS,
                             kv_bits=4, kv_capacity=capacity,
                             prompt_cache_callback=held.append)
    next(first)
    first.close()
    rec = forcing(model, tokens)
    for _ in ar.generate_step(embeds, model, position_ids=pos,
                              rope_deltas=deltas, max_tokens=len(tokens),
                              sampler=rec, prompt_cache=held[0],
                              prefix_len=prefix):
        pass
    return rec.rows(len(tokens))


def code_flips(a: list, b: list, lo: int, hi: int) -> tuple:
    """4-bit codes that differ between two caches' buffers (cache_buffers)
    in rows [lo, hi) of row 0: (flips, codes)."""
    import torch

    flips = total = 0
    for x, y in zip(a, b):
        if x.dtype == torch.uint8:  # two codes a byte
            d = x[:, 0, :, lo:hi] ^ y[:, 0, :, lo:hi]
            flips += int(((d & 0xF) != 0).sum() + ((d >> 4) != 0).sum())
            total += 2 * d.numel()
    return flips, total


def apc_want(counts: dict, n_layers: int, chunks: int, flash: int,
             fused_steps: int = 0, k6_steps: int = 0,
             k2_steps: int = 0) -> dict:
    """The launches of one single-stream request: K1 196 a prefill chunk,
    K4 28 a chunk that takes it, K2 one head for the prefill (and 197 a
    per-linear decode step), K3 a fused decode step, K6 28 a step."""
    want = {k: 0 for k in counts}
    want["int4_matmul"] = 7 * n_layers * chunks
    want["flash_attention"] = n_layers * flash
    want["int4_matvec"] = 1 + (7 * n_layers + 1) * k2_steps
    want["fused_decode"] = fused_steps
    want["int4_kv_attention"] = n_layers * k6_steps
    return want


def apc_block(model, proc, cfg, total: dict) -> None:
    """(l1) (c)'s image and ~8.5k-token prompt cold through
    stream_generate(apc=APCManager(), vision_cache=...): every full block of
    16 tokens stored, no hit; (l2) a second turn (the prompt, (l1)'s reply
    and ~400 new tokens): the hit is the longest shared multiple of 16, the
    restored rows byte-equal to (l1)'s, K1 / K4 only on the suffix's
    chunks (K4 at offset = the prefix), K3 every decode step, the vision
    tower not run again; (l2c) (l2)'s prompt cold without APC in a cache of
    (l2)'s capacity, teacher-forced with (l2)'s tokens: its logits hold
    (l2)'s by the parity rule, the two TTFTs side by side."""
    import torch

    from mlx_vlm_tpu_torch.generate.common import round_up
    from mlx_vlm_tpu_torch import apc as apc_mod
    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs
    from mlx_vlm_tpu_torch.vision_cache import VisionFeatureCache

    n_layers = model.language_model.args.num_hidden_layers
    apc, vc = apc_mod.APCManager(), VisionFeatureCache()
    harvests, restores = [], []
    timed(apc, "commit", harvests)
    timed(apc, "make_warm_cache", restores)
    image = _image(448)
    msgs = [{"role": "user", "content": [{"type": "image"},
                                         {"type": "text", "text": LONG_TEXT}]}]
    p1 = apply_chat_template(proc, cfg, msgs, num_images=1)
    r1 = apc_turn(model, proc, "(l1)", p1, image, apc, vc)
    S1 = r1["S"]
    snap = apc.snapshot()
    block_bytes = sum(b.k.nbytes + b.v.nbytes for b in apc.blocks.values())
    cap1 = round_up(S1 + APC_TOKENS + 32 + 65, 256)
    chunks1, step1 = suffix_chunks(0, S1, cap1)
    print(f"  (l1) block mode, cold: prompt {S1} tokens, TTFT "
          f"{r1['ttft']:.4f} s; harvest {harvests[0][0]:.4f} s for "
          f"{harvests[0][1]} blocks, {block_bytes / 1e6:.1f} MB to the host "
          f"(warm-cache build at prefix 0 {restores[0][0]:.4f} s); pool "
          f"{snap['used_blocks']} blocks, {pool_bytes(apc) / 1e6:.1f} MB of "
          f"host memory; stats {apc.stats.as_dict()}; launches "
          f"{r1['counts']}", flush=True)
    if not (snap["used_blocks"] == snap["stores"] == S1 // APC_BLOCK
            and snap["hits"] == 0 and snap["lookups"] == 1):
        fail(f"(l1): pool {snap}, want {S1 // APC_BLOCK} blocks, no hit")
    expect("(l1)", r1["counts"], apc_want(
        r1["counts"], n_layers, chunks1, chunks1 * (step1 >= 256),
        fused_steps=r1["steps"]), total)
    k1 = r1["cache"].k[:, 0, :, :S1].clone()
    v1 = r1["cache"].v[:, 0, :, :S1].clone()
    tok1 = prepare_inputs(proc, p1, images=image)["input_ids"][0].tolist()

    # the conversation continued in Qwen2-VL's chat format, the image left
    # in the first turn (apply_chat_template puts a message list's images
    # in its last user turn, which would move it)
    p2 = (f"{p1}{r1['text']}<|im_end|>\n<|im_start|>user\n{APC_TURN2}"
          f"<|im_end|>\n<|im_start|>assistant\n")
    inputs2 = prepare_inputs(proc, p2, images=image)
    tok2 = inputs2["input_ids"][0].tolist()
    r2 = apc_turn(model, proc, "(l2)", p2, image, apc, vc)
    S2 = r2["S"]
    prefix = min(shared_prefix(tok1, tok2), S1, S2 - 1) // APC_BLOCK \
        * APC_BLOCK
    cap2 = round_up(S2 + APC_TOKENS + 32 + 65, 256)
    chunks2, step2 = suffix_chunks(prefix, S2, cap2)
    same_rows = (torch.equal(r2["cache"].k[:, 0, :, :prefix], k1[:, :, :prefix])
                 and torch.equal(r2["cache"].v[:, 0, :, :prefix],
                                 v1[:, :, :prefix]))
    print(f"  (l2) block mode, warm: prompt {S2} tokens, hit "
          f"{apc.stats.hit_tokens} tokens (want {prefix}), suffix "
          f"{S2 - prefix} rows in {chunks2} chunk(s) of {step2}; TTFT "
          f"{r2['ttft']:.4f} s, restore {restores[-1][0]:.4f} s, harvest "
          f"{harvests[-1][0]:.4f} s for {harvests[-1][1]} new blocks; "
          f"restored rows [0, {prefix}) byte-equal to (l1)'s {same_rows}; "
          f"vision tower runs {vc.misses}, cache hits {vc.hits}; pool "
          f"{len(apc.blocks)} blocks, {pool_bytes(apc) / 1e6:.1f} MB; "
          f"launches {r2['counts']}", flush=True)
    if not (apc.stats.hits == 1 and apc.stats.hit_tokens == prefix > 0):
        fail(f"(l2): stats {apc.stats.as_dict()}, want one hit of {prefix}")
    if not same_rows:
        fail("(l2): the restored rows differ from (l1)'s")
    if (vc.misses, vc.hits) != (1, 1):
        fail(f"(l2): the vision tower ran {vc.misses} times")
    expect("(l2)", r2["counts"], apc_want(
        r2["counts"], n_layers, chunks2, chunks2 * (step2 >= 256),
        fused_steps=r2["steps"]), total)
    del k1, v1, r1

    toks2 = r2["tokens"]
    ref, ttft_c, _ = forced_cold(model, inputs2, vc, toks2, cap2)
    ok, err, tol, n_margin = parity_rule(ref, r2["logits"])
    print(f"  (l2c) (l2)'s prompt cold, no APC, kv_capacity {cap2}, teacher-"
          f"forced with (l2)'s {len(toks2)} tokens: max|warm - cold| = "
          f"{err:.4e}, tol {tol:.4e}; argmax checked on {n_margin} steps "
          f"{'ok' if ok else 'MISMATCH'}; TTFT warm {r2['ttft']:.4f} s vs "
          f"cold {ttft_c:.4f} s", flush=True)
    if not ok:
        fail("(l2) differs from its prompt prefilled cold")


def apc_exact(model, proc, cfg, total: dict) -> None:
    """Exact mode at kv_bits=4 (K6): (l3) (a)'s image with ~2k tokens of
    text, its prompt sized to 40 past a multiple of 256 so that its
    snapshot (round_up(S3 + 16 + 16 + 1, 256) rows) holds (l4)'s
    continuation (lookup_exact asks round_up(S4 + 16 + 32 + 65, 256));
    (l4) the same prompt with a 64-token follow-up: one hit of S3, the
    restored cache byte-equal to (l3)'s in every buffer's rows [0, S3) with
    its cursor at S3, K6 28 a step; (l4c) (l4) cold with kv_capacity the
    snapshot's: the share of differing 4-bit codes in the shared rows and
    in the suffix rows printed, its logits held to (l4)'s by the parity
    rule."""
    import torch

    from mlx_vlm_tpu_torch.generate.common import round_up
    from mlx_vlm_tpu_torch import apc as apc_mod
    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.core.cache import cache_buffers
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    n_layers = model.language_model.args.num_hidden_layers
    image = _image(448)

    def prompt(n_chars: int) -> str:
        text = (APC_EXACT_TEXT * 60)[:n_chars]
        return apply_chat_template(proc, cfg, text, num_images=1)

    n = 2000
    S = prepare_inputs(proc, prompt(n), images=image)["input_ids"].shape[1]
    n += (40 - S) % 256
    p3 = prompt(n)
    S3 = prepare_inputs(proc, p3, images=image)["input_ids"].shape[1]
    p4 = p3 + APC_FOLLOW_UP[:64]
    inputs4 = prepare_inputs(proc, p4, images=image)
    S4 = inputs4["input_ids"].shape[1]
    snap_cap = round_up(S3 + APC_TOKENS + APC_TOKENS + 1, 256)
    if not (S3 % 256 == 40 and S4 == S3 + 64
            and snap_cap >= round_up(S4 + APC_TOKENS + 32 + 65, 256)):
        fail(f"(l3)/(l4): prompts of {S3} and {S4} tokens do not fit a "
             f"snapshot of {snap_cap} rows")
    apc = apc_mod.APCManager()
    restored = []
    real_lookup = apc.lookup_exact

    def lookup(*a, **k):
        n_hit, cache = real_lookup(*a, **k)
        if cache is not None:  # its cursor as restored, before any prefill
            restored.append(int(cache.offset))
        return n_hit, cache

    apc.lookup_exact = lookup
    stores = []
    timed(apc, "store_exact", stores)
    r3 = apc_turn(model, proc, "(l3)", p3, image, apc, None, kv_bits=4)
    chunks3, _ = suffix_chunks(0, S3, snap_cap)
    want3 = apc_want(r3["counts"], n_layers, chunks3, 0, k6_steps=r3["steps"],
                     k2_steps=r3["steps"])
    expect("(l3)", r3["counts"], want3, total)
    (_, snap, cap), = apc._exact.values()
    rows3 = [t[:, 0, :, :S3].clone() for t in cache_buffers(r3["cache"])]
    print(f"  (l3) exact mode, kv_bits=4, cold: prompt {S3} tokens, TTFT "
          f"{r3['ttft']:.4f} s, {chunks3} prefill chunks; snapshot "
          f"{stores[0][0]:.4f} s, {pool_bytes(apc) / 1e6:.1f} MB on the "
          f"host, {cap} rows (its buffers'), cursor {int(snap.offset)}; "
          f"launches {r3['counts']}", flush=True)
    if cap != snap_cap or int(snap.offset) != S3:
        fail(f"(l3): snapshot of {cap} rows at {int(snap.offset)}, want "
             f"{snap_cap} at {S3}")
    del r3

    r4 = apc_turn(model, proc, "(l4)", p4, image, apc, None, kv_bits=4)
    chunks4, step4 = suffix_chunks(S3, S4, snap_cap)
    same = restored == [S3] and all(
        torch.equal(t[:, 0, :, :S3], r)
        for t, r in zip(cache_buffers(r4["cache"]), rows3))
    print(f"  (l4) exact mode, warm: prompt {S4} tokens, hit "
          f"{apc.stats.hit_tokens} tokens, suffix {S4 - S3} rows in "
          f"{chunks4} chunk(s) of {step4}; TTFT {r4['ttft']:.4f} s; restored "
          f"cursor {restored}, every buffer's rows [0, {S3}) byte-equal to "
          f"(l3)'s {same}; launches {r4['counts']}", flush=True)
    if not (apc.stats.hits == 1 and apc.stats.hit_tokens == S3):
        fail(f"(l4): stats {apc.stats.as_dict()}, want one hit of {S3}")
    if not same:
        fail("(l4): the restored cache differs from (l3)'s")
    expect("(l4)", r4["counts"], apc_want(
        r4["counts"], n_layers, chunks4, 0, k6_steps=r4["steps"],
        k2_steps=r4["steps"]), total)
    warm = [t[:, :, :, :S4].clone() for t in cache_buffers(r4["cache"])]
    del r4["cache"]

    toks4 = r4["tokens"]
    layout = layout_reference(model, inputs4, S3, toks4, snap_cap)
    ok, err, tol, n_margin = parity_rule(layout, r4["logits"])
    print(f"  (l4) vs its prompt prefilled in (l4)'s own layout without "
          f"APC ([0, {S3}) as (l3) prefilled it, then the suffix in one "
          f"chunk at {S3}), teacher-forced with its {len(toks4)} tokens: "
          f"max|warm - layout| = {err:.4e}, tol {tol:.4e}; argmax checked "
          f"on {n_margin} steps {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("(l4) differs from its prompt prefilled in its own layout")
    ref, ttft_c, cold = forced_cold(model, inputs4, None, toks4, snap_cap,
                                    kv_bits=4)
    shared = code_flips(warm, cache_buffers(cold), 0, S3)
    suffix = code_flips(warm, cache_buffers(cold), S3, S4)
    ok, err, tol, n_margin = parity_rule(ref, r4["logits"])
    print(f"  (l4c) (l4)'s prompt cold at kv_bits=4, kv_capacity {snap_cap}"
          f": 4-bit codes differing from (l4)'s cache: shared rows "
          f"{shared[0]} of {shared[1]} ({100 * shared[0] / shared[1]:.4f}%), "
          f"the {S4 - S3} suffix rows {suffix[0]} of {suffix[1]} "
          f"({100 * suffix[0] / suffix[1]:.4f}%); teacher-forced with (l4)'s "
          f"{len(toks4)} tokens: max|warm - cold| = {err:.4e}, tol "
          f"{tol:.4e}; argmax checked on {n_margin} steps "
          f"{'ok' if ok else 'MISMATCH'}; TTFT warm {r4['ttft']:.4f} s vs "
          f"cold {ttft_c:.4f} s", flush=True)
    if not ok:
        fail("(l4) differs from its prompt prefilled cold")


def apc_server(model, cfg, total: dict) -> None:
    """(m) create_server(apc=APCManager(), 4 slots of 4096 rows, blocks of
    8): (m1) a chat with a ~1,500-token system prompt, then, once it has
    answered, (m2) the same system prompt with another question.
    /v1/cache/stats shows 2 lookups and 1 hit of the shared multiple of 16;
    (m2)'s K1 launches cover its suffix's chunks only; one capture; (m2)'s
    logits held by the parity rule to its prompt alone on the single stream
    (per-linear, K2 at M = 1), teacher-forced with its tokens;
    /v1/cache/reset empties the pool."""
    import socket
    import threading

    from mlx_vlm_tpu_torch.generate.common import round_up
    from mlx_vlm_tpu_torch import apc as apc_mod
    from mlx_vlm_tpu_torch.generate import batch
    from mlx_vlm_tpu_torch.server.app import create_server
    from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    proc = _processor()
    n_layers = model.language_model.args.num_hidden_layers
    rec = ServerRecorder(model.language_model.args.vocab_size, model.device)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    real_make = batch.make_batched_sampler
    batch.make_batched_sampler = lambda: rec
    apc = apc_mod.APCManager()
    try:
        httpd = create_server(model, proc, model_name="qwen2-vl-7b-random",
                              host="127.0.0.1", port=port,
                              num_slots=SERVER_SLOTS,
                              capacity=SERVER_CAPACITY,
                              block_size=SERVER_BLOCK, apc=apc)
    finally:
        batch.make_batched_sampler = real_make
    generator = httpd.state.generator
    rec.attach(generator.batch)
    seen = []
    real_generate = generator.generate
    generator.generate = lambda args: (seen.append(args),
                                       real_generate(args))[1]
    restores = []
    timed(apc, "make_warm_cache", restores)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{port}"
    out = []
    try:
        for i, q in enumerate(APC_QUESTIONS):
            body = {"messages": [{"role": "system", "content": APC_SYSTEM},
                                 {"role": "user", "content": q}],
                    "max_tokens": APC_TOKENS}
            chunks0 = generator.batch.stats["prefill_chunks"]
            reset_counts()
            t0 = time.perf_counter()
            status, _, raw = _http(url, "/v1/chat/completions", body)
            wall = time.perf_counter() - t0
            if status != 200:
                fail(f"(m{i + 1}): answered {status}: {raw[:300]}")
            answer = json.loads(raw)
            # the owner thread records the request's metrics after its
            # last token: wait for them before the counters are read
            for _ in range(500):
                recent = json.loads(_http(url, "/metrics")[2])["recent"]
                if len(recent) > i:
                    break
                time.sleep(0.01)
            counts = read_counts()
            out.append((answer, counts, wall, recent[i],
                        generator.batch.stats["prefill_chunks"] - chunks0))
        status, _, raw = _http(url, "/v1/cache/stats")
        stats = json.loads(raw)
        status, _, raw = _http(url, "/v1/cache/reset", {})
        status, _, raw2 = _http(url, "/v1/cache/stats")
        after = json.loads(raw2)
    finally:
        httpd.shutdown()
        generator.shutdown()
        server.join(timeout=30)
    st = dict(generator.batch.stats)
    rows = rec.rows()
    inputs = [prepare_inputs(proc, a.prompt) for a in seen]
    toks = [i["input_ids"][0].tolist() for i in inputs]
    S = [len(t) for t in toks]
    prefix = min(shared_prefix(*toks), S[0], S[1] - 1) // APC_BLOCK \
        * APC_BLOCK
    want_chunks = [suffix_chunks(0, S[0], round_up(S[0] + 65, 256))[0],
                   suffix_chunks(prefix, S[1], round_up(S[1] + 65, 256))[0]]
    for i, (answer, counts, wall, env, chunks) in enumerate(out):
        n = answer["usage"]["completion_tokens"]
        print(f"  (m{i + 1}) server with APC: prompt {S[i]} tokens, {n} "
              f"tokens in {wall:.4f} s; /metrics ttft_s {env['ttft_s']:.4f}, "
              f"generation_tps {env['generation_tps']:.2f}; {chunks} prefill "
              f"chunk(s) (want {want_chunks[i]}); warm-cache build "
              f"{restores[i][0]:.4f} s; launches {counts}", flush=True)
        if chunks != want_chunks[i]:
            fail(f"(m{i + 1}): {chunks} prefill chunks, want {want_chunks[i]}")
        if (counts["int4_matmul"] != 7 * n_layers * chunks
                or counts["fused_decode"] or env["generation_tokens"] != n
                + (answer["choices"][0]["finish_reason"] == "stop")):
            fail(f"(m{i + 1}): K1 launched {counts['int4_matmul']} times "
                 f"(want {7 * n_layers * chunks}), K3 "
                 f"{counts['fused_decode']} (want 0); {n} tokens answered, "
                 f"{env['generation_tokens']} generated")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    print(f"  (m) /v1/cache/stats {stats}; after /v1/cache/reset "
          f"used_blocks {after['used_blocks']}; generator: "
          f"{st['captures']} capture, {st['steps']} steps, "
          f"{st['admissions']} admissions", flush=True)
    if not (stats["lookups"] == 2 and stats["hits"] == 1
            and stats["hit_tokens"] == prefix > 0
            and after["used_blocks"] == 0
            and st["captures"] == int(generator.batch.decode.use_graph)):
        fail(f"(m): cache stats {stats}, after reset {after}, want 2 "
             f"lookups and one hit of {prefix}; generator {st}")
    uid = seen[1].request_id
    logits, rtoks = rows[uid]
    n = out[1][3]["generation_tokens"]
    logits, rtoks = logits[:n], rtoks[:n]
    os.environ["MLX_VLM_TPU_FUSED_DECODE"] = "0"
    decide_fused_decode(model)
    try:
        ref, _ = teacher_forced_logits(model, inputs[1], forced=rtoks[:-1],
                                       n_steps=len(rtoks))
    finally:
        del os.environ["MLX_VLM_TPU_FUSED_DECODE"]
        decide_fused_decode(model)
    ok, err, tol, n_margin = parity_rule(ref, logits)
    print(f"  (m2) vs its prompt alone on the single stream (per-linear, K2 "
          f"at M = 1), teacher-forced with its {len(rtoks)} tokens: "
          f"max|served - alone| = {err:.4e}, tol {tol:.4e}; argmax checked "
          f"on {n_margin} steps {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("(m2) differs from its prompt run alone")


def run_apc(model, cfg, total: dict) -> None:
    """The prefix-caching part: block mode (l1)/(l2)/(l2c), exact mode
    (l3)/(l4)/(l4c) and the server (m); prints its seconds."""
    t0 = time.perf_counter()
    proc = _processor()
    apc_block(model, proc, cfg, total)
    apc_exact(model, proc, cfg, total)
    apc_server(model, cfg, total)
    print(f"  prefix-caching part: {time.perf_counter() - t0:.1f} s",
          flush=True)


# ------------------------------------------------------------ phase 4, speculative


# verify calls a RoundRecorder keeps (a request's rounds; a server's)
SPEC_ROUNDS = 80


class RoundRecorder:
    """What a speculative request's rounds computed, kept without a host
    read inside a round: each call of the target's head on k + 1 positions
    (the verify) copies its f32 logits into a device ring at a device
    counter, so a captured round records at every replay; each round's
    result and, for a batch (`gen`), the owner of each slot are kept on
    the host (CapturedRounds.run wrapped); the first token's logits are
    kept too: the single stream's prefill head (the target's first head
    call) or, for a batch, each admission's rows (the generator's `_first`
    wrapped), with each admission's layout (`admitted`: uid -> (its row,
    the uids of its admission's rows, (rows, padded length, chunk)), the
    generator's `_prefill` wrapped).  A with block installs the hooks; the
    ring must outlive any replay of a round captured inside it."""

    def __init__(self, model, rows: int, gen=None):
        import torch

        self.lm = model.language_model
        self.ring = torch.zeros(
            (SPEC_ROUNDS, rows, SPEC_K + 1, self.lm.args.vocab_size),
            dtype=torch.float32, device=model.device)
        self.count = torch.zeros((), dtype=torch.int64, device=model.device)
        self.gen, self.rounds, self.first = gen, [], {}
        self.admitted, self.layout = {}, None
        if gen is not None:
            prefill, first = gen._prefill, gen._first

            def prefill_hook(cache, embeds, pos, last_idx, step):
                self.layout = (embeds.shape[0], embeds.shape[1], step)
                return prefill(cache, embeds, pos, last_idx, step)

            def first_hook(logits, reqs):
                toks = first(logits, reqs)
                uids = [r.uid for r in reqs]
                for i, r in enumerate(reqs):
                    self.first[r.uid] = (logits[i].float().cpu().numpy(),
                                         int(toks[i]))
                    self.admitted[r.uid] = (i, uids, self.layout)
                return toks

            gen._prefill, gen._first = prefill_hook, first_hook

    def __enter__(self):
        from mlx_vlm_tpu_torch.speculative import utils as su

        real_logits, real_run = self.lm.logits, su.CapturedRounds.run
        self.su, self.real_run = su, real_run

        def logits(params, hidden):
            out = real_logits(params, hidden)
            if hidden.shape[1] == SPEC_K + 1:
                at = self.count.clamp(max=SPEC_ROUNDS - 1).reshape(1)
                self.ring.index_copy_(0, at, out.float()[None])
                self.count.add_(1)
            elif self.gen is None and not self.first:
                self.first[0] = (out[0, -1].float().cpu().numpy(), None)
            return out

        def run(rounds):
            gen = self.gen
            owners = [0] if gen is None else [
                s.req.uid if s is not None and gen.active[i] else None
                for i, s in enumerate(gen.slots)]
            res = real_run(rounds)
            self.rounds.append((owners, res))
            return res

        self.lm.logits = logits
        su.CapturedRounds.run = run
        return self

    def __exit__(self, *exc):
        del self.lm.logits
        self.su.CapturedRounds.run = self.real_run

    def rows(self, n_tokens: dict) -> dict:
        """{uid: (logits [n, V], tokens [n])}: its first token's, then, for
        each round it was live in, the verify's rows up to its accept count
        (its committed tokens), cut to its n tokens."""
        count = int(self.count)
        if count != len(self.rounds) or count > SPEC_ROUNDS:
            fail(f"speculative recorder: {count} verify calls for "
                 f"{len(self.rounds)} rounds (room for {SPEC_ROUNDS})")
        out = {u: ([lg], [t]) for u, (lg, t) in self.first.items()}
        for r, (owners, res) in enumerate(self.rounds):
            verify = self.ring[r].cpu().numpy()
            for i, u in enumerate(owners):
                if u is None:
                    continue
                n_acc = int(res[i, -1])
                out[u][0].extend(verify[i, :n_acc + 1])
                out[u][1].extend(int(t) for t in res[i, :n_acc + 1])
        return {u: (np.stack(lg[:n_tokens[u]]), t[:n_tokens[u]])
                for u, (lg, t) in out.items() if u in n_tokens}


def part_ms(fn, gen, iters: int = 10) -> float:
    """Device ms of fn() captured alone in a CUDA graph (drawing from the
    registered generator `gen`) and replayed between CUDA events."""
    import torch

    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    ms = _events_ms(graph.replay, iters)
    del graph
    return ms


def time_round(rounds, S: int) -> dict:
    """Device ms of one single-stream round (its captured graph replayed)
    and of its draft (k drafter steps) and its verify (the target's
    forward, both models' filtered probabilities, the walk and the rewind)
    each captured alone; every replay starts with both cursors put back to
    S + 1.  The round's graph also holds the recorder's copy of its verify
    logits (k + 1 rows of V f32, 3 MB)."""
    import torch

    e = rounds.engine
    at = torch.full((), S + 1, dtype=torch.int32, device=rounds.dev)

    def restore():
        rounds.cache.offset.copy_(at)
        rounds.d_cache.offset.copy_(at)

    restore()
    d_toks, d_logits = e.draft(rounds.d_cache, rounds.tok, rounds.sp,
                               rounds.gen)
    draft = part_ms(lambda: (restore(), e.draft(
        rounds.d_cache, rounds.tok, rounds.sp, rounds.gen)), rounds.gen)
    verify = part_ms(lambda: (restore(), e.verify(
        rounds.cache, rounds.tok, d_toks, d_logits, rounds.deltas, rounds.sp,
        rounds.gen)), rounds.gen)
    whole = _events_ms(lambda: (restore(), rounds.graph.graph.replay()), 10)
    return {"round": whole, "draft": draft, "verify": verify}


def break_even(ratio: float, k: int):
    """The per-draft acceptance a at which a round of device time `ratio`
    plain decode steps pays for itself: its expected tokens (1 - a^(k+1))
    / (1 - a) (Leviathan et al., independent acceptances) equal `ratio`;
    None when even full acceptance (k + 1 tokens) does not."""
    if ratio <= 1.0:
        return 0.0
    if ratio > k + 1:
        return None
    lo, hi = 0.0, 1.0
    for _ in range(60):
        a = (lo + hi) / 2
        if sum(a ** i for i in range(k + 1)) < ratio:
            lo = a
        else:
            hi = a
    return lo


def spec_want(st: dict, n_layers: int, d_layers: int, flash: bool) -> dict:
    """Launches of a single-stream speculative request: both models'
    prefill chunks on K1 (and K4 on every layer where the cache takes the
    flash route), the target's prefill head on K2, and per round k drafter
    steps and the sync, each one K3 launch with the head inside (the
    drafter's fused route), and the verify (linears and head) at
    M = k + 1 on K2."""
    want = {k: 0 for k in read_counts()}
    C = st["prefill_chunks"]
    want["int4_matmul"] = 7 * (n_layers + d_layers) * C
    want["int4_matvec"] = 1 + st["rounds"] * (7 * n_layers + 1)
    want["fused_decode"] = st["rounds"] * (SPEC_K + 1)
    want["flash_attention"] = (n_layers + d_layers) * C if flash else 0
    return want


def spec_request(model, drafter, proc, cfg, name: str, text: str, image,
                 max_tokens: int, total: dict, temperature: float = 0.0,
                 step_ms=None) -> dict:
    """One speculative request through stream_generate(draft_model=), the
    counters set to 0 just before it and read just after; its rounds'
    verify logits recorded.  Checks its launches (spec_want), one capture,
    a replay per round after the first and one fetch per round and one for
    the first token; greedy, its logits are held by the parity rule to its
    prompt alone through plain greedy decoding (spec_parity).  Prints its rounds, drafted and accepted tokens and its
    times; returns its stats and numbers."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template, stream_generate
    from mlx_vlm_tpu_torch.generate.common import embed_prompt
    from mlx_vlm_tpu_torch.speculative import utils as su
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    n_img = int(image is not None)
    prompt = apply_chat_template(proc, cfg, text, num_images=n_img)
    inputs = prepare_inputs(proc, prompt, images=image)
    S = inputs["input_ids"].shape[1]
    rec = RoundRecorder(model, 1)
    times, toks = [], []
    with rec:
        reset_counts()
        tic = time.perf_counter()
        for res in stream_generate(model, proc, prompt, image=image,
                                   max_tokens=max_tokens, draft_model=drafter,
                                   num_draft_tokens=SPEC_K,
                                   temperature=temperature, seed=5):
            times.append(time.perf_counter())
            toks.append(res.token)
        counts = read_counts()
        rounds = su.last_rounds
        st = dict(rounds.stats)
        n = len(toks)
        logits, rec_toks = rec.rows({0: n})[0]
        n_acc = [int(r[0, -1]) for _, r in rec.rounds]
        parts = time_round(rounds, S)
    lm = model.language_model
    flash = rounds.cache.capacity >= 8192
    want = spec_want(st, lm.args.num_hidden_layers,
                     drafter.language_model.args.num_hidden_layers, flash)
    expect(name, counts, want, total)
    accepted, drafted = sum(n_acc), SPEC_K * len(n_acc)
    V = lm.args.vocab_size
    finished = n == max_tokens or toks[-1] in _eos(model, proc)
    # the recorder knows the first token's logits, not its token
    if not (finished and rec_toks[1:] == toks[1:]
            and all(0 <= t < V for t in toks)
            and st["captures"] == 1 and st["replays"] == st["rounds"] - 1
            and st["fetches"] == st["rounds"] + 1
            and len(n_acc) == st["rounds"]
            and sum(n_acc) + len(n_acc) >= n - 1):
        fail(f"{name}: {n} tokens, recorded {rec_toks[:8]}..., stats {st}, "
             f"accepts {n_acc}")
    host_ms = 1e3 * (st["round_s"] - st["first_s"] - st["capture_s"]) / max(
        st["replays"], 1)
    print(f"  {name}: prompt {S} tokens, {n} tokens in {st['rounds']} rounds "
          f"of k = {SPEC_K}: drafted {drafted}, accepted {accepted} "
          f"(acceptance {accepted / max(drafted, 1):.4f}, "
          f"{n / max(st['rounds'], 1):.3f} tokens a round); TTFT "
          f"{times[0] - tic:.4f} s, {(n - 1) / (times[-1] - times[0]):.2f} "
          f"tok/s; first round {st['first_s']:.4f} s, capture "
          f"{st['capture_s']:.4f} s, {st['replays']} replays, "
          f"{st['fetches']} fetches; a round: {parts['round']:.4f} ms on the "
          f"device (draft {parts['draft']:.4f} ms and verify "
          f"{parts['verify']:.4f} ms, each captured alone; the sync and "
          f"the rewinds the rest), {host_ms:.4f} ms on the host per "
          f"replayed round (dispatch to its tokens fetched); launches "
          f"{counts}", flush=True)
    if temperature == 0.0:
        layout = spec_layout(S, rounds.cache.capacity)
        if layout[1] // layout[2] != st["prefill_chunks"]:
            fail(f"{name}: {st['prefill_chunks']} prefill chunks, the layout "
                 f"{layout} has {layout[1] // layout[2]}")
        spec_parity(model, [embed_prompt(model, inputs) + (inputs,)], 0,
                    layout, toks, logits, name)
    if step_ms is not None:
        ratio = parts["round"] / step_ms
        a = break_even(ratio, SPEC_K)
        print(f"    a round costs {ratio:.3f} plain decode steps "
              f"({step_ms:.4f} ms a step on the device): it pays for itself "
              f"from a per-draft acceptance of "
              f"{'none (k + 1 tokens do not cover it)' if a is None else f'{a:.4f}'}"
              f" (this request's {accepted / max(drafted, 1):.4f} with random "
              f"weights)", flush=True)
    su.last_rounds = None
    return {"stats": st, "accepted": accepted, "drafted": drafted,
            "parts": parts, "tokens": toks}


def verify_layout_logits(model, prompts: list, row: int, layout: tuple,
                         toks: list, accepts: list, rows: int,
                         capacity: int) -> np.ndarray:
    """Plain greedy decoding of the prompt in row `row` of an admission,
    teacher-forced with `toks`, laid out as a batched speculative server
    ran its verify: the prompt prefilled as its admission prefilled it
    (admission_layout_logits) and copied into every row of a `rows`-row
    cache of `capacity` rows, then for each round (`accepts`: the row's
    accept count in each round it was live) one forward over [the last
    token, the round's accepted tokens, zeros up to k] in every row, so
    that each linear runs at the served verify's M = rows * (k + 1) (K1)
    and each row's arithmetic is the served row's; the cursors advance by
    the round's committed count.  No drafter, no walk and none of the
    generator's code runs.  Returns logits [len(toks), V]: the prefill's,
    then each round's committed positions."""
    import torch

    from mlx_vlm_tpu_torch.core import cache as cache_lib

    lm = model.language_model
    lp = model.params["language_model"]
    first, single = admission_layout_logits(model, prompts, row, layout, [],
                                            None)
    S, delta = prompts[row][0].shape[1], int(prompts[row][2][0, 0])
    cache = cache_lib.init_batch_cache(
        lm.args.num_hidden_layers, rows, lm.n_kv_heads, lm.head_dim,
        capacity, prompts[row][0].dtype, device=model.device)
    for r in range(rows):
        cache_lib.insert_row(cache, single, r, S)
    out, at = [first[0]], 1
    for n_acc in accepts:
        seq = toks[at - 1:at + n_acc]
        seq = seq + [0] * (SPEC_K + 1 - len(seq))
        ids = torch.tensor([seq] * rows, device=model.device)
        pos = (cache.offset.long() + delta)[:, None] + torch.arange(
            SPEC_K + 1, device=model.device)
        hidden = lm(lp, lm.embed(lp, ids), cache,
                    pos[None].expand(3, rows, SPEC_K + 1))
        logits = lm.logits(lp, hidden)[0].float().cpu().numpy()
        cache.offset.sub_(SPEC_K - n_acc)
        out.extend(logits[:n_acc + 1])
        at += n_acc + 1
    return np.stack(out[:len(toks)])


def spec_parity(model, prompts: list, row: int, layout: tuple, toks: list,
                logits: np.ndarray, name: str, accepts=None, rows: int = 1,
                capacity: int = 0) -> None:
    """A greedy speculative answer's logits (its first token's, then its
    rounds' verify rows) held by the parity rule to its prompt alone in
    plain greedy decoding, teacher-forced with its tokens, its prompt
    prefilled as the request's or admission's prefill laid it out
    (`prompts`, each embed_prompt's output and its inputs, `row` its own,
    `layout` (rows, padded length, chunk)): a single stream decoded on the
    per-linear route (K2 at M = 1, the verify's own layers at M = k + 1);
    a batched answer (`accepts` given) in its verify's layout
    (verify_layout_logits: K1 at M = rows * (k + 1)).  Printed beside it,
    not held: the per-linear route at M = 1 from the same prefill (for a
    batched answer), and the prompt prefilled in one unpadded chunk on
    the per-linear and the fused (K3) routes."""
    from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode

    inputs = prompts[row][3]
    embedded = [p[:3] for p in prompts]
    refs = {}
    try:
        with env_vars(MLX_VLM_TPU_FUSED_DECODE="0"):
            decide_fused_decode(model)
            refs["per-linear, same prefill"], _ = admission_layout_logits(
                model, embedded, row, layout, toks[:-1], None)
            if accepts is not None:
                refs["held"] = verify_layout_logits(
                    model, embedded, row, layout, toks, accepts, rows,
                    capacity)
            refs["per-linear, unpadded"], _ = teacher_forced_logits(
                model, inputs, forced=toks[:-1], n_steps=len(toks))
        with env_vars(MLX_VLM_TPU_FUSED_DECODE="1"):
            decide_fused_decode(model)
            refs["K3, unpadded"], _ = teacher_forced_logits(
                model, inputs, forced=toks[:-1], n_steps=len(toks))
    finally:
        decide_fused_decode(model)
    held = refs.pop("held", None)
    if held is None:
        held = refs.pop("per-linear, same prefill")
        what = "on the per-linear route (K2 at M = 1)"
    else:
        what = (f"in its verify's layout ({rows} rows of k + 1, K1 at M = "
                f"{rows * (SPEC_K + 1)})")
    ok, err, tol, n_margin = parity_rule(held, logits)
    at = int(np.abs(logits - held).max(-1).argmax())
    others = "; ".join(f"{k} {parity_rule(v, logits)[1]:.4e}"
                       for k, v in refs.items())
    print(f"    {name} vs its prompt alone, prefilled as it was ({layout[0]} "
          f"rows of {layout[1]}, chunks of {layout[2]}), plain greedy {what}, "
          f"teacher-forced with its {len(toks)} tokens: max|verify - plain| "
          f"= {err:.4e} (at token {at}), tol {tol:.4e}; argmax checked on "
          f"{n_margin} steps {'ok' if ok else 'MISMATCH'}; not held: {others}",
          flush=True)
    if not ok:
        fail(f"{name}: the speculative tokens fail the parity rule")


def spec_layout(S: int, capacity: int) -> tuple:
    """speculative_generate_step's prefill layout for a prompt of S tokens
    into caches of `capacity` rows: (1, padded length, chunk)."""
    step = min(512, 256 * -(-S // 256))
    S_pad = step * -(-S // step)
    while S_pad > capacity and step > 64:
        step = max(64, step // 2)
        S_pad = step * -(-S // step)
    return 1, S_pad, step


def _eos(model, proc) -> tuple:
    from mlx_vlm_tpu_torch.generate.dispatch import _get_eos_ids

    return tuple(_get_eos_ids(model, proc))


# (s5)'s chats: (text, temperature), 32 tokens each, sent at once
SPEC_SERVER_CHATS = (("Write a short story about a lighthouse.", 0.0),
                     ("List the planets of the solar system in order.", 0.0),
                     ("Name three colors.", 0.7),
                     ("What is the capital of France?", 0.7))


def spec_server(model, drafter, proc, cfg, total: dict) -> None:
    """(s5): a server with the drafter (create_server(draft_model=), 4
    slots, blocks of 8, k = 4) answering four chats sent at once, two
    greedy and two at temperature 0.7.  Every chat answered (200, its text
    its tokens' text, its usage its tokens), /metrics' envelope of each
    carrying "speculative"; one round capture for the generator, a replay
    a round after the first; launches held to what ran (K1: the prefill
    chunks of both models and per round the drafter's catch-up and the
    verify at M = 20 with its head; K2: the admissions' heads and per
    round the catch-up's head and k - 1 drafter steps at M = 4); then each
    greedy answer's verify logits held by the parity rule to its prompt
    alone through plain greedy decoding (spec_parity)."""
    import socket
    import threading

    from mlx_vlm_tpu_torch.generate.common import embed_prompt
    from mlx_vlm_tpu_torch.server.app import create_server
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    httpd = create_server(model, proc, model_name="qwen2-vl-7b-random",
                          host="127.0.0.1", port=port, num_slots=4,
                          capacity=SERVER_CAPACITY, block_size=SERVER_BLOCK,
                          draft_model=drafter, num_draft=SPEC_K)
    generator = httpd.state.generator
    gen = generator.batch
    rec = RoundRecorder(model, 4, gen)
    seen_args = []
    real_generate = generator.generate

    def logging_generate(args):
        seen_args.append(args)
        return real_generate(args)

    generator.generate = logging_generate
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{port}"
    answers = {}

    def chat(i, text, temp):
        t0 = time.perf_counter()
        status, _, raw = _http(url, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": text}],
            "max_tokens": 32, "temperature": temp})
        answers[i] = (status, json.loads(raw) if status == 200 else raw,
                      time.perf_counter() - t0)

    try:
        with rec:
            reset_counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=chat, args=(i, t, temp))
                       for i, (t, temp) in enumerate(SPEC_SERVER_CHATS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            counts = read_counts()
            if any(t.is_alive() for t in threads):
                fail("(s5): a chat did not finish in 600 s")
            metrics = json.loads(_http(url, "/metrics")[2])
            envs = {e.get("request_id"): e for e in metrics["recent"]}
            by_text = {a.prompt: a for a in seen_args}
            n_tokens = {a.request_id: envs[a.request_id]["generation_tokens"]
                        for a in seen_args}
            rows = rec.rows(n_tokens)
    finally:
        httpd.shutdown()
        generator.shutdown()
        server.join(timeout=30)
    st = dict(gen.decode.stats)
    if generator._thread.is_alive():
        fail("(s5): the generator's owner thread did not stop")
    eos = _eos(model, proc)
    n_layers = model.language_model.args.num_hidden_layers
    d_layers = drafter.language_model.args.num_hidden_layers
    held, n_total = [], 0
    for i, (text, temp) in enumerate(SPEC_SERVER_CHATS):
        status, ans, secs = answers.get(i, (None, None, 0.0))
        args = next((a for p, a in by_text.items() if text in p), None)
        if status != 200 or args is None:
            fail(f"(s5) chat {i}: {status} {ans}")
        env = envs[args.request_id]
        logits, toks = rows[args.request_id]
        n = env["generation_tokens"]
        content = ans["choices"][0]["message"]["content"]
        done = ans["usage"]["completion_tokens"]
        ended_eos = bool(toks) and toks[-1] in eos
        if not ("speculative" in env and len(toks) == n
                and done == n - ended_eos and (n == 32 or ended_eos)
                and content == served_text(proc, toks, eos)
                and all(0 <= t < model.language_model.args.vocab_size
                        for t in toks)):
            fail(f"(s5) chat {i}: answer {ans}, {len(toks)} recorded tokens, "
                 f"envelope {env}")
        n_total += done
        spec = env["speculative"]
        print(f"  (s5) chat {i} (temperature {temp}): {done} tokens, finish "
              f"{ans['choices'][0]['finish_reason']}, {secs:.4f} s; /metrics:"
              f" ttft_s {env['ttft_s']:.4f}, generation_tps "
              f"{env['generation_tps']:.2f}, speculative {spec}", flush=True)
        if temp == 0.0:
            held.append((i, args.request_id, logits, toks))
    R = st["rounds"]
    want = {k: 0 for k in counts}
    want["int4_matmul"] = (7 * n_layers * st["prefill_chunks"]
                           + 7 * d_layers * st["drafter_chunks"]
                           + R * (7 * d_layers + 7 * n_layers + 1))
    want["int4_matvec"] = st["prefill_heads"] + R * (
        1 + (SPEC_K - 1) * (7 * d_layers + 1))
    if not (st["captures"] == 1 and st["replays"] == R - 1
            and st["fetches"] == R + st["admissions"]):
        fail(f"(s5): generator counts {st}, want one capture, a replay per "
             f"round after the first and a fetch per round and admission")
    ms_round = 1e3 * (st["decode_s"] - st["first_s"] - st["capture_s"]) / max(
        st["replays"], 1)
    print(f"  (s5) server with the drafter, 4 chats at once: {n_total} tokens "
          f"in {wall:.4f} s, {n_total / wall:.2f} tok/s aggregate; {R} "
          f"rounds: {st['captures']} capture ({st['capture_s']:.4f} s), "
          f"{st['replays']} replays, {st['fetches']} fetches ({R} rounds + "
          f"{st['admissions']} admissions), {ms_round:.4f} ms per replayed "
          f"round on the host; launches {counts}", flush=True)
    expect("(s5)", counts, want, total)
    inputs = {a.request_id: prepare_inputs(proc, a.prompt)
              for a in seen_args}
    for i, uid, logits, toks in held:
        row, uids, layout = rec.admitted[uid]
        accepts = [int(res[owners.index(uid), -1])
                   for owners, res in rec.rounds if uid in owners]
        spec_parity(model, [embed_prompt(model, inputs[u]) + (inputs[u],)
                            for u in uids], row, layout, toks, logits,
                    f"(s5) greedy chat {i}", accepts, gen.B, gen.capacity)


def plain_step_ms(model, proc, cfg) -> float:
    """Device ms of one plain greedy decode step of the loaded target (its
    fused route, K3): a short request's captured step replayed alone
    between CUDA events."""
    from mlx_vlm_tpu_torch import apply_chat_template, stream_generate
    from mlx_vlm_tpu_torch.generate import ar

    prompt = apply_chat_template(proc, cfg, "Name three colors.",
                                 num_images=0)
    for _ in stream_generate(model, proc, prompt, max_tokens=8):
        pass
    ms = _events_ms(ar.last_decode.graph.graph.replay, 10)
    ar.last_decode = None
    return ms


def run_speculative(model, cfg, total: dict) -> None:
    """The speculative part, on (a)-(f)'s model and a drafter at the 2B's
    widths built and folded once (spec_drafter): (s1) (a)'s image and
    prompt, greedy, 64 tokens; (s2) the target as its own drafter, text,
    greedy, 32 tokens (most drafts should be accepted, up to the verify's
    K2 at M = 5 against the drafter's K3 steps in bf16); (s3) (c)'s
    image and ~8.2k-token prompt, 16 tokens (K4 on both models' prefill
    chunks); (s4) temperature 0.7 with a seed, text, 32 tokens; (s5) a
    server with the drafter, four chats at once.  k = 4 throughout.  The
    part prints the ms of one plain decode step beside a round's and the
    per-draft acceptance at which a round pays for itself."""
    import torch

    t_part = time.perf_counter()
    proc = _processor()
    t0 = time.perf_counter()
    drafter = spec_drafter(n_layers=SPEC_DRAFTER_LAYERS)
    d_args = drafter.language_model.args
    print(f"  speculative part: drafter at Qwen2-VL-2B widths (hidden "
          f"{d_args.hidden_size}, {d_args.num_hidden_layers} layers, "
          f"{d_args.num_attention_heads}/{d_args.num_key_value_heads} heads, "
          f"intermediate {d_args.intermediate_size}) with the 7B's vocab "
          f"{d_args.vocab_size}: both packages refuse the published 2B vocab "
          f"151936 beside this target (validate_drafter_compatibility "
          f"compares vocab sizes); random mlx 4-bit weights built and loaded "
          f"once in {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    step_ms = plain_step_ms(model, proc, cfg)
    spec_request(model, drafter, proc, cfg, "(s1) image 448x448 + short "
                 "prompt, 2B-width drafter", "Describe this image in "
                 "detail.", _image(448), 64, total, step_ms=step_ms)
    s2 = spec_request(model, model, proc, cfg, "(s2) text, the target as its "
                      "own drafter", "Write a short story about a "
                      "lighthouse.", None, 32, total, step_ms=step_ms)
    print(f"    (s2) acceptance {s2['accepted'] / max(s2['drafted'], 1):.4f} "
          f"(the same model drafts, its steps on K3 and the verify on K2 at "
          f"M = 5: they round differently, so near 1, not 1)", flush=True)
    spec_request(model, drafter, proc, cfg, "(s3) image + ~8.2k-token "
                 "prompt, 2B-width drafter", LONG_TEXT, _image(448), 16,
                 total)
    s4 = spec_request(model, drafter, proc, cfg, "(s4) text, temperature 0.7, "
                      "seed 5, 2B-width drafter", "Write a short story about "
                      "a lighthouse.", None, 32, total, temperature=0.7)
    if not (s4["drafted"] == SPEC_K * s4["stats"]["rounds"]
            and 0 <= s4["accepted"] <= s4["drafted"]):
        fail(f"(s4): inconsistent stats {s4}")
    spec_server(model, drafter, proc, cfg, total)
    del drafter
    torch.cuda.empty_cache()
    print(f"  speculative part: {time.perf_counter() - t_part:.1f} s",
          flush=True)


# ---------------------------------------------------- target-coupled drafters
# The drafter kinds on Llama-3.1-8B (exact, K5): EAGLE-3 and MTP drafting
# DRAFT_K tokens a round (a verify of DRAFT_K + 1 rows on K5's GEMV),
# DFlash's block of 16 (its 16-row verify and 15-row draft head on the
# GEMM), DDTree's tree of DDTREE_BUDGET nodes over DFlash's block (a
# [bonus | tree] forward of 1 + DDTREE_BUDGET rows)
DRAFT_KINDS = ("eagle3", "mtp", "dflash", "ddtree")
DRAFT_K = 4
DDTREE_BUDGET = 8
DRAFT_TEXT = "Write a short story about a lighthouse."
# phase 3: the target cut to 3 layers, so EAGLE-3 captures layers 0, 1, 2
# and DFlash (2 of its 5 layers) reads the same 3 (their widths are the
# published ones); the ring of recorded head rows
DRAFT_PHASE3_LAYERS = 3
DRAFT_RING_ROWS = 2048


def drafter_configs(phase3: bool) -> dict:
    """{kind: drafter config.json} at Llama-3.1-8B's widths
    (utils/testing.py `llama_3_1_8b_drafter_configs`); for phase 3 the
    capture and target ids of a 3-layer target, and DFlash at 2 layers."""
    from mlx_vlm_tpu_torch.utils.testing import llama_3_1_8b_drafter_configs

    cfgs = llama_3_1_8b_drafter_configs()
    if phase3:
        cfgs["eagle3"]["capture_layers"] = [0, 1, 2]
        cfgs["dflash"]["num_hidden_layers"] = 2
        cfgs["dflash"]["dflash_config"]["target_layer_ids"] = [0, 1, 2]
    return cfgs


def card_drafter(kind: str, cfg: dict, seed: int, dev):
    """(drafter, params) of `kind` built from its config.json the way
    `load_drafter` builds it, its random bf16 weights drawn on the card
    (a torch generator seeded `seed`: drawing 0.2-1.1 billion weights with
    numpy would take the host tens of seconds), without the embedding and
    head, which it takes from the target (`bind`)."""
    import torch

    from mlx_vlm_tpu_torch.speculative import drafters as dr
    from mlx_vlm_tpu_torch.speculative.drafters import (dflash, eagle3,
                                                        mtp)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(*shape):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * 0.05).to(torch.bfloat16)

    fields = {k: cfg[k] for k in dr._CFG_FIELDS if k in cfg}
    kw = dict(dtype=torch.bfloat16, device=dev, draw=draw)
    if kind == "eagle3":
        d = dr.Eagle3Drafter(dr.Eagle3Config(
            capture_layers=tuple(cfg["capture_layers"]), **fields))
        p = eagle3.init_eagle3_params(d.config, **kw)
    elif kind == "mtp":
        d = dr.MTPDrafter(dr.MTPConfig(**fields))
        p = mtp.init_mtp_params(d.config, **kw)
    else:
        dc = cfg["dflash_config"]
        d = dr.DFlashDrafter(dr.DFlashConfig(
            **fields, num_hidden_layers=cfg["num_hidden_layers"],
            head_dim=cfg["head_dim"], block_size=cfg["block_size"],
            mask_token_id=dc["mask_token_id"],
            target_layer_ids=tuple(dc["target_layer_ids"])))
        p = dflash.init_dflash_params(d.config, **kw)
    for k in ("embed_tokens", "lm_head"):
        p.pop(k, None)
    return d, p


def bound_to(drafter, params: dict, model, dtype) -> tuple:
    """A copy of (drafter, params) for `model` (another device or dtype):
    the params moved, an EAGLE-3 / MTP drafter bound to `model`."""
    import copy

    import torch

    def move(t):
        if isinstance(t, dict):
            return {k: move(v) for k, v in t.items()}
        return t.to(model.device, dtype)

    d = copy.copy(drafter)
    if hasattr(d, "bind"):
        d.bind(model.language_model, model.params["language_model"])
    return d, move(params)


def drafter_step(kind: str):
    """The kind's generate step (speculative/)."""
    from mlx_vlm_tpu_torch.speculative import ddtree, dflash, utils

    return {"eagle3": utils.eagle3_generate_step,
            "mtp": utils.eagle3_generate_step,
            "dflash": dflash.dflash_generate_step,
            "ddtree": ddtree.tree_generate_step}[kind]


def drafter_kwargs(kind: str, adaptive: bool = False) -> dict:
    if kind in ("eagle3", "mtp"):
        return {"num_draft": DRAFT_K}
    if kind == "dflash":
        return {"adaptive": adaptive}
    return {"tree_budget": DDTREE_BUDGET}


class HeadRecorder:
    """The rows of the target's head after each `forward_captured` and
    `forward_masked` (the prefill, each verify, DDTree's tree forward and
    replay), copied into a device ring at a device counter, so that a
    captured round records at every replay; each CapturedRounds.run
    result (the round's tokens and n_acc) and each DDTree walk (the tree's
    greedy tokens and the path) kept on the host.  `rows(kind, tokens)`:
    the recorded row that produced each committed token."""

    def __init__(self, model):
        import torch

        self.lm = model.language_model
        self.ring = torch.zeros((DRAFT_RING_ROWS, self.lm.args.vocab_size),
                                dtype=torch.float32, device=model.device)
        self.count = torch.zeros((), dtype=torch.int64, device=model.device)
        self.results, self.walks = [], []

    def __enter__(self):
        import torch

        from mlx_vlm_tpu_torch.speculative import ddtree
        from mlx_vlm_tpu_torch.speculative import utils as su

        lm, armed = self.lm, [False]
        real = {n: getattr(lm, n) for n in ("forward_captured",
                                            "forward_masked", "logits")}
        self.su, self.dd = su, ddtree
        self.real_run, self.real_walk = su.CapturedRounds.run, \
            ddtree.walk_tree

        def arm(name):
            def call(*a, **kw):
                armed[0] = True
                return real[name](*a, **kw)
            return call

        def logits(params, hidden):
            out = real["logits"](params, hidden)
            if armed[0]:
                armed[0] = False
                n = out.shape[1]
                at = (self.count + torch.arange(n, device=out.device)).clamp(
                    max=DRAFT_RING_ROWS - 1)
                self.ring.index_copy_(0, at, out[0].float())
                self.count.add_(n)
            return out

        def run(rounds):
            res = self.real_run(rounds)
            self.results.append(res)
            return res

        def walk(tree, greedy):
            path = self.real_walk(tree, greedy)
            self.walks.append((np.asarray(greedy), path))
            return path

        lm.forward_captured = arm("forward_captured")
        lm.forward_masked = arm("forward_masked")
        lm.logits = logits
        su.CapturedRounds.run = run
        ddtree.walk_tree = walk
        return self

    def __exit__(self, *exc):
        for n in ("forward_captured", "forward_masked", "logits"):
            delattr(self.lm, n)
        self.su.CapturedRounds.run = self.real_run
        self.dd.walk_tree = self.real_walk

    def rows(self, kind: str, n: int) -> np.ndarray:
        """[n, V]: the recorded row that produced each of the n committed
        tokens: the prefill's, then each round's verify rows up to n_acc
        (EAGLE-3, MTP, DFlash: k + 1 rows a round), or (DDTree: the tree's
        rows, then the replay's last) the tree's bonus row, the rows of
        the path's nodes but the last, and the replay's row."""
        count = int(self.count)
        if count > DRAFT_RING_ROWS:
            fail(f"{kind}: {count} head rows recorded, room for "
                 f"{DRAFT_RING_ROWS}")
        ring = self.ring[:count].cpu().numpy()
        out, at = [ring[0]], 1
        if kind == "ddtree":
            for greedy, path in self.walks:
                tree = ring[at:at + len(greedy)]
                if path:  # path[0] from the bonus row, path[j] from j - 1's
                    out += [tree[0]] + [tree[p + 1] for p in path[:-1]]
                out.append(ring[at + len(greedy)])
                at += len(greedy) + 1
        else:
            for res in self.results:
                n_acc = int(res[0, -1])
                out += list(ring[at:at + n_acc + 1])
                at += res.shape[1] - 1
        if at != count:
            fail(f"{kind}: {count} head rows recorded, {at} accounted for")
        return np.stack(out[:n])


def drafter_stream(model, drafter, params, kind: str, embeds, n: int,
                   graph: bool = True, adaptive: bool = False) -> tuple:
    """One request of `kind` through its generate step, greedy, `n`
    tokens, with every round's verify (and tree) head rows recorded:
    (tokens, [n, V] rows, stats, the rounds object(s), host seconds, the
    recorder, whose ring a captured round writes at every replay, so it
    must outlive any further replay).  `graph` False runs every round
    eagerly on the card.  Fails unless each token is the argmax of its
    row."""
    from mlx_vlm_tpu_torch.speculative import utils as su
    from mlx_vlm_tpu_torch.speculative.dflash import DFlashStats

    stats = DFlashStats() if kind in ("dflash", "ddtree") else su.SpecStats()
    real_init = su.CapturedRounds.__init__

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        self.use_graph = self.use_graph and graph

    su.CapturedRounds.__init__ = init
    try:
        with HeadRecorder(model) as rec:
            tic = time.perf_counter()
            toks = [int(t[0]) for t, _ in drafter_step(kind)(
                embeds, model, drafter, params, max_tokens=n, stats=stats,
                **drafter_kwargs(kind, adaptive))]
            secs = time.perf_counter() - tic
    finally:
        su.CapturedRounds.__init__ = real_init
    rows = rec.rows(kind, n)
    if len(toks) != n or not np.array_equal(rows.argmax(-1), toks):
        fail(f"{kind}: a committed token is not the argmax of the target's "
             f"own verify row: {toks} vs {rows.argmax(-1).tolist()}")
    return toks, rows, stats, last_rounds_of(kind), secs, rec


def last_rounds_of(kind: str):
    from mlx_vlm_tpu_torch.speculative import ddtree, dflash, utils

    return {"eagle3": utils, "mtp": utils, "dflash": dflash,
            "ddtree": ddtree}[kind].last_rounds


def rounds_state(kind: str, rounds) -> list:
    """The caches of a request's rounds (the target's and the drafter's
    buffers and cursors), for bit-identity checks."""
    if isinstance(rounds, dict):  # DFlash's / DDTree's by size
        r = next(iter(rounds.values()))
    else:
        r = rounds
    out = [r.cache.k, r.cache.v, r.cache.offset]
    if hasattr(r, "d_cache"):
        out += [r.d_cache.k, r.d_cache.v, r.d_cache.offset]
    return [t.clone() for t in out]


def prompt_embeds(model, proc, cfg):
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    prompt = apply_chat_template(proc, cfg, DRAFT_TEXT, num_images=0)
    ids = torch.from_numpy(np.asarray(prepare_inputs(proc, prompt)[
        "input_ids"], np.int64)).to(model.device)
    return model.get_input_embeddings(model.params, ids), ids


def teacher_forced(model, ids, toks: list) -> np.ndarray:
    """The target's plain logits [n, V] (f32) at the positions that
    produced the n tokens: the prompt and all but the last token in one
    uncached causal forward."""
    import torch

    lm, lp = model.language_model, model.params["language_model"]
    seq = torch.cat([ids, torch.tensor([toks[:-1]], dtype=torch.int64,
                                       device=ids.device)], dim=1)
    S = ids.shape[1]
    h = lm(lp, lm.embed(lp, seq), None,
           torch.arange(seq.shape[1], device=ids.device)[None])
    return lm.logits(lp, h[:, S - 1:]).float()[0].cpu().numpy()


def drafter_logits_forced(model, drafter, params, kind: str, ids,
                          first: int, forced=None) -> tuple:
    """The drafter's first-round logits on `model`'s device from the card's
    first token: EAGLE-3 / MTP [k, V], DFlash / DDTree [15, V] (the block
    from the prompt's capture on this device).  EAGLE-3 / MTP steps take
    their token and feature from `forced` (the card's (drafts, features)),
    so each step is held on the card's inputs (random weights amplify a
    step's bf16 rounding along the chain of the drafter's own features),
    or, when it is None, their own argmax and feature, the first feature
    from this device's capture.  Returns (logits, (drafts, the input
    feature of each step))."""
    import torch

    from mlx_vlm_tpu_torch.speculative.utils import captured_prefill

    lm, lp = model.language_model, model.params["language_model"]
    dev, dt = model.device, lm_dtype(model)
    cache = lm.init_cache(1, 256, dt, device=dev)
    _, hiddens = captured_prefill(lm, lp, lm.embed(lp, ids), cache)
    d_cache = drafter.init_cache(1, 256, dt, device=dev)
    tok = torch.tensor([first], device=dev)
    if kind in ("eagle3", "mtp"):
        feat = drafter.fuse_features(params, hiddens[:, :, -1:])[:, 0]
        rows, fed, feats = [], [], []
        for i in range(DRAFT_K):
            if forced is not None:
                feat = torch.from_numpy(forced[1][i]).to(dev, dt)[None]
            feats.append(feat[0].float().cpu().numpy())
            lg, feat = drafter.step(params, d_cache, tok, feat,
                                    torch.tensor(i, device=dev))
            rows.append(lg[0].float())
            fed.append(int(lg[0].argmax()) if forced is None
                       else forced[0][i])
            tok = torch.tensor([fed[-1]], device=dev)
        return torch.stack(rows).cpu().numpy(), (fed, feats)
    drafter.append_fn(ids.shape[1])(params, d_cache,
                                    drafter.fuse_ctx(hiddens), ids.shape[1])
    bs = drafter.config.block_size
    lg = drafter.draft_logits_fn(lm, bs)(model.params, params, d_cache, tok)
    return lg[0].cpu().numpy(), None


def tree_logits(model, ids, tree_seq: np.ndarray, depths: np.ndarray,
                amask: np.ndarray) -> np.ndarray:
    """The target's `forward_masked` head rows [T, V] over a tree after
    the prompt (read-only), on `model`'s device."""
    import torch

    lm, lp = model.language_model, model.params["language_model"]
    dev = model.device
    cache = lm.init_cache(1, 256, lm_dtype(model), device=dev)
    lm(lp, lm.embed(lp, ids), cache,
       torch.arange(ids.shape[1], device=dev)[None])
    pos = (cache.offset.long() + torch.from_numpy(depths).to(dev))[None]
    h = lm.forward_masked(lp, lm.embed(lp, torch.from_numpy(tree_seq).to(
        dev)), cache, pos, torch.from_numpy(amask).to(dev))
    return lm.logits(lp, h)[0].float().cpu().numpy()


def lm_dtype(model):
    return model.params["language_model"]["model"]["norm"]["weight"].dtype


def zero_norms(model, params: dict):
    """A with-block's state: the target's final norm and the drafter's
    (a copy of `params`) zeroed, so every logit row is 0 and every draft
    and greedy token is 0 (the all-accepted case)."""
    norm = model.params["language_model"]["model"]["norm"]["weight"]
    saved = norm.clone()
    zp = dict(params, norm={"weight": params["norm"]["weight"] * 0})

    class Zeroed:
        def __enter__(self):
            norm.zero_()
            return zp

        def __exit__(self, *exc):
            norm.copy_(saved)

    return Zeroed()


def boosted(logits):
    """Block logits with token 0 far above the rest (50 there, 0
    elsewhere), so that DDTree's best-first tree is the chain of 0s."""
    out = logits * 0
    out[..., 0] = 50.0
    return out


def all_accepted(model, drafter, params, kind: str, embeds) -> tuple:
    """The all-accepted case on the card: the final norms of target and
    drafter zeroed, so that every logit row is 0 and every greedy token
    and draft is token 0; for DDTree the drafter's block logits also have
    token 0 as their one maximum (with all of them tied, numpy's argsort
    puts other tokens first, so the tree would hold no 0), so its tree is
    a chain of 0s.  (ok, summary)."""
    import copy

    from mlx_vlm_tpu_torch.speculative.ddtree import (build_ddtree,
                                                      walk_tree)

    n = 24
    if kind == "ddtree":
        drafter = copy.copy(drafter)
        real = drafter.draft_logits_fn
        drafter.draft_logits_fn = lambda lm, bs: (
            lambda *a: boosted(real(lm, bs)(*a)))
    with zero_norms(model, params) as zp:
        toks, _, st, _, _, _ = drafter_stream(model, drafter, zp, kind,
                                              embeds, n)
    if kind in ("eagle3", "mtp"):
        per = DRAFT_K - 1
    elif kind == "dflash":
        per = drafter.config.block_size - 1
    else:
        tree = build_ddtree(boosted(np.zeros(
            (drafter.config.block_size - 1, 8), np.float32)), DDTREE_BUDGET)
        per = len(walk_tree(tree, np.zeros(len(tree) + 1, np.int64)))
    recent = getattr(st, "recent", None)
    ok = toks == [0] * n and st.rounds > 0 and per > 0 and (
        st.accepted == per * st.rounds if recent is None
        else all(a == per for a, _ in recent[:-1]))
    return ok, (f"all accepted (final norms zeroed): {n} tokens of 0 in "
                f"{st.rounds} rounds, {st.accepted} of {st.drafted} drafts "
                f"accepted ({per} a round)")


def phase_drafter_parity(ckpt: tuple) -> bool:
    """The target-coupled drafters at full width against the CPU: the
    Llama-3.1-8B checkpoint cut to DRAFT_PHASE3_LAYERS layers, exact (K5)
    on the card in bf16 and plain on the CPU in f32; each kind's drafter
    at Llama-3.1-8B's widths (drafter_configs(phase3=True)) drawn on the
    card, its f32 copy on the CPU.  For each kind: the card's 16 greedy
    tokens (rounds captured and replayed) and their verify rows held by
    the parity rule to the CPU's plain logits teacher-forced with those
    tokens; the same request with every round eager, its tokens and both
    caches bit-identical; the drafter's first-round logits on both
    devices, teacher-forced with the card's first token, drafts and
    features (DDTree: the [bonus | tree] forward of the card's first
    tree), by the parity rule; the all-accepted case."""
    import torch

    from mlx_vlm_tpu_torch.speculative.ddtree import (build_ddtree,
                                                      tree_ancestor_mask)

    print(f"phase 3: target-coupled drafters (EAGLE-3, MTP, DFlash, DDTree) "
          f"at Llama-3.1-8B widths, target cut to {DRAFT_PHASE3_LAYERS} "
          f"layers, exact (K5), vs the CPU in float32", flush=True)
    t0 = time.perf_counter()
    cfg, w = sliced(ckpt, DRAFT_PHASE3_LAYERS)
    with env_vars(MLX_VLM_TPU_RUNTIME_QUANT="exact"):
        from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights

        gpu = load_model_from_weights(cfg, w, torch.bfloat16, "cuda")
        cpu = load_model_from_weights(cfg, w, torch.float32, "cpu")
    proc = _processor(model=gpu)
    embeds, ids = prompt_embeds(gpu, proc, cfg)
    cpu_ids = ids.cpu()
    print(f"  (loads: {time.perf_counter() - t0:.1f} s)", flush=True)
    forced_cache, ok_all, n = {}, True, 16
    cfgs = drafter_configs(phase3=True)
    for kind in DRAFT_KINDS:
        t1 = time.perf_counter()
        dcfg = cfgs["dflash" if kind == "ddtree" else kind]
        d, p = card_drafter("dflash" if kind == "ddtree" else kind, dcfg,
                            SEED + 20 + DRAFT_KINDS.index(kind), gpu.device)
        gd, gp = bound_to(d, p, gpu, torch.bfloat16)
        cd, cp = bound_to(d, p, cpu, torch.float32)
        reset_counts()
        toks, rows, st, rounds, _, rec = drafter_stream(gpu, gd, gp, kind,
                                                        embeds, n)
        counts = read_counts()
        state = rounds_state(kind, rounds)
        del rounds, rec
        etoks, _, _, erounds, _, _ = drafter_stream(gpu, gd, gp, kind,
                                                    embeds, n, graph=False)
        estate = rounds_state(kind, erounds)
        same = etoks == toks and all(torch.equal(a, b)
                                     for a, b in zip(state, estate))
        key = tuple(toks)
        if key not in forced_cache:
            forced_cache[key] = teacher_forced(cpu, cpu_ids, toks)
        ok_t, err_t, tol_t, n_t = parity_rule(forced_cache[key], rows)
        first = toks[0]
        g_d, forced = drafter_logits_forced(gpu, gd, gp, kind, ids, first)
        if kind == "ddtree":
            tree = build_ddtree(g_d, DDTREE_BUDGET)
            seq = np.asarray([[first] + [x.token_ids[-1] for x in tree]])
            depths = np.asarray([0] + [x.depth for x in tree])
            amask = tree_ancestor_mask(tree)
            g_d = tree_logits(gpu, ids, seq, depths, amask)
            c_d = tree_logits(cpu, cpu_ids, seq, depths, amask)
        else:
            c_d, _ = drafter_logits_forced(cpu, cd, cp, kind, cpu_ids, first,
                                           forced)
        ok_d, err_d, tol_d, n_d = parity_rule(c_d, g_d)
        ok_a, acc = all_accepted(gpu, gd, gp, kind, embeds)
        what = ("the [bonus | tree] forward" if kind == "ddtree"
                else "the drafter's first-round logits")
        ok = ok_t and ok_d and same and ok_a
        ok_all &= ok
        print(f"  {kind}: {n} tokens in {st.rounds} rounds ({st.accepted} of "
              f"{st.drafted} drafts accepted); verify rows vs the CPU "
              f"teacher-forced: max|cuda - cpu| = {err_t:.4e}, tol "
              f"{tol_t:.4e}, argmax checked on {n_t}/{n}; {what} vs the "
              f"CPU: {err_d:.4e}, tol {tol_d:.4e}, argmax checked on "
              f"{n_d}/{len(c_d)}; replayed rounds vs eager (tokens and both "
              f"caches) bit-identical {same}; {acc} {ok_a}; qmatmul_int4 "
              f"launches {counts['qmatmul_int4']}; "
              f"{'ok' if ok else 'MISMATCH'} "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
    del gpu, cpu
    torch.cuda.empty_cache()
    return ok_all


def time_rounds(rounds, iters: int = 5) -> float:
    """Device ms of one captured round replayed alone between CUDA events
    (it moves both cursors on, inside the capacity's slack)."""
    return _events_ms(rounds.graph.graph.replay, iters)


def drafter_want(counts: dict, kind: str, L: int, rounds: int) -> dict:
    """K5 launches of a drafter request on the exact target: the prefill's
    7 L linears and its head, then a round's: EAGLE-3 / MTP 7 L + 1 (the
    verify) + DRAFT_K (the drafter's head on the target's table), DFlash
    7 L + 1 + 1 (the block's head), DDTree 14 L + 3 (the block's head, the
    tree forward and the replay); every other counter 0."""
    want = {k: 0 for k in counts}
    per = {"eagle3": 7 * L + 1 + DRAFT_K, "mtp": 7 * L + 1 + DRAFT_K,
           "dflash": 7 * L + 2, "ddtree": 14 * L + 3}[kind]
    want["qmatmul_int4"] = 7 * L + 1 + per * rounds
    return want


def run_drafters(model, cfg: dict, total: dict) -> None:
    """Phase 4's drafter requests on the 32-layer exact Llama-3.1-8B: each
    kind's full-width drafter written as a checkpoint (without the
    embedding and head) and loaded onto the card by `load_drafter`, then
    32 greedy tokens of DRAFT_TEXT (DFlash adaptive and with fixed blocks
    of 16), each request's K5 launches held to its rounds, every committed
    token the argmax of the target's own verify row, the stream the plain
    greedy one wherever the plain step's top-2 margin exceeds twice the
    parity bound; rounds, drafted and accepted tokens, a round's device ms
    against the plain step's and host ms per round printed."""
    import tempfile

    import torch

    from mlx_vlm_tpu_torch.speculative.drafters import load_drafter
    from mlx_vlm_tpu_torch.utils.testing import write_drafter_checkpoint

    t0 = time.perf_counter()
    proc = _processor(model=model)
    L = model.language_model.args.num_hidden_layers
    embeds, ids = prompt_embeds(model, proc, cfg)
    plain_ms = plain_step_ms(model, proc, cfg)
    n = 32
    cfgs = drafter_configs(phase3=False)
    loaded = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("eagle3", "mtp", "dflash"):
            t1 = time.perf_counter()
            d, p = card_drafter(kind, cfgs[kind], SEED + 30 + len(loaded),
                                model.device)
            write_drafter_checkpoint(f"{tmp}/{kind}", cfgs[kind], p)
            del d, p
            loaded[kind] = load_drafter(f"{tmp}/{kind}", model,
                                        dtype=torch.bfloat16)
            if loaded[kind][2] != kind:
                fail(f"load_drafter gave {loaded[kind][2]} for {kind}")
            print(f"  {kind} drafter: checkpoint written and loaded onto "
                  f"the card in {time.perf_counter() - t1:.1f} s", flush=True)
    forced = {}
    for kind, adaptive in (("eagle3", False), ("mtp", False),
                           ("dflash", True), ("dflash", False),
                           ("ddtree", False)):
        d, p, _ = loaded["dflash" if kind == "ddtree" else kind]
        name = f"(z) Llama-3.1-8B exact, {kind}" + (
            ", adaptive blocks" if adaptive else "")
        reset_counts()
        toks, rows, st, rounds, secs, rec = drafter_stream(
            model, d, p, kind, embeds, n, adaptive=adaptive)
        counts = read_counts()
        if tuple(toks) not in forced:
            forced[tuple(toks)] = teacher_forced(model, ids, toks)
        ok, err, tol, n_m = parity_rule(forced[tuple(toks)], rows)
        if not ok:
            fail(f"{name}: the stream or its verify rows leave the plain "
                 f"greedy decode: max|verify - plain| = {err:.4e}, tol "
                 f"{tol:.4e}")
        expect(name, counts, drafter_want(counts, kind, L, st.rounds), total)
        # the captured program timed: the round (DFlash: its largest
        # block's), DDTree's tree forward; host ms over the replayed ones
        graphs = rounds if isinstance(rounds, dict) else {0: rounds}
        timed = graphs[max(graphs)]
        dev_ms = time_rounds(timed) if timed.graph is not None else \
            float("nan")
        sts = [g.stats for g in graphs.values()]
        replays = sum(x["replays"] for x in sts)
        replay_s = sum(x["round_s"] - x["first_s"] - x["capture_s"]
                       for x in sts if x["captures"])
        del rec
        what = ("the tree forward's" if kind == "ddtree" else
                f"a {max(graphs)}-row block's round" if kind == "dflash"
                else "a round's")
        print(f"  {name}: {n} tokens in {st.rounds} rounds, {st.drafted} "
              f"drafted, {st.accepted} accepted; {secs:.3f} s with the "
              f"prefill, {sum(x['captures'] for x in sts)} captures; "
              f"{1e3 * replay_s / max(replays, 1):.4f} host ms per replayed "
              f"{'tree forward' if kind == 'ddtree' else 'round'}"
              f"{f', {1e3 * secs / st.rounds:.4f} per round' if kind == 'ddtree' else ''}; "
              f"{what} device ms {dev_ms:.4f} (captured, replayed alone) "
              f"against the plain step's {plain_ms:.4f}; qmatmul_int4 "
              f"{counts['qmatmul_int4']} launches, "
              f"{(counts['qmatmul_int4'] - 7 * L - 1) / st.rounds:.1f} a "
              f"round; every token the argmax of its verify row; stream vs "
              f"plain greedy (teacher-forced): max|verify - plain| = "
              f"{err:.4e}, tol {tol:.4e}, argmax held on {n_m}/{n} "
              f"margins", flush=True)
    print(f"  drafter part: {time.perf_counter() - t0:.1f} s", flush=True)


def expect(name: str, counts: dict, want: dict, total: dict) -> None:
    """Fail unless each counter in `want` holds its count; add the request's
    counts to `total`."""
    for k, v in want.items():
        if counts[k] != v:
            fail(f"{name}: {k} launched {counts[k]} times, want {v}")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_main_path(ckpts: dict) -> dict:
    """Qwen2-VL-7B, then Qwen2.5-VL-7B and Qwen3-VL-8B, at full width
    through the public entry points; returns the kernels' launch counts
    summed over the requests, each request's counted from 0."""
    import torch

    from mlx_vlm_tpu_torch.utils.loader import (decide_fused_decode,
                                                load_model_from_weights)

    print("phase 4: main path, Qwen2-VL-7B full width (28 decoder layers, 32 "
          "vision blocks), random mlx 4-bit weights, greedy", flush=True)
    t0 = time.perf_counter()
    cfg, weights = ckpts["qwen2_vl_7b"]
    t1 = time.perf_counter()
    model = load_model_from_weights(cfg, weights, torch.bfloat16, "cuda")
    t2 = time.perf_counter()
    n_layers = model.language_model.args.num_hidden_layers
    print(f"  checkpoint built in phase 3 (family_checkpoints), loaded "
          f"(fold of the layers phase 3 did not fold + stack + "
          f"upload) in {t2 - t1:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    proc = _processor()
    long_text = LONG_TEXT
    if not model.language_model.fused_decode:
        fail("the 7B model did not take the fused decode route")
    requests = [  # (name, text, image, images, max_tokens, fused route,
        #             kv_bits, MLX_VLM_TPU_TQ_SCHEME)
        ("(a) image 448x448 + short prompt", "Describe this image in detail.",
         _image(448), 1, 100, True, None, None),
        ("(b) text only", "Write a short story about a lighthouse.", None, 0,
         100, False, None, None),
        ("(c) image + ~8.2k-token prompt", long_text, _image(448), 1, 16,
         True, None, None),
        ("(d) as (c), kv_bits 3.5", long_text, _image(448), 1, 16, True, 3.5,
         None),
        ("(e) as (c), kv_bits 3.5 split", long_text, _image(448), 1, 16, True,
         3.5, "split"),
        ("(f) as (c), kv_bits 4", long_text, _image(448), 1, 16, True, 4,
         None),
    ]
    total: dict = {}
    for (name, text, image, n_img, max_tokens, fused, kv_bits,
         tq) in requests:
        os.environ["MLX_VLM_TPU_FUSED_DECODE"] = "1" if fused else "0"
        if decide_fused_decode(model) != fused:
            fail(f"{name}: the fused route did not switch to {fused}")
        kv_kernel = KV_KERNEL.get((kv_bits, tq))
        route = kv_kernel if kv_kernel else "K3" if fused else "per-linear"
        counts, n, _, steps = run_request(
            model, proc, cfg, name, route, text, image, n_img, max_tokens,
            kv_bits, {"MLX_VLM_TPU_TQ_SCHEME": tq})
        # each decode step that ran (the first eager, the rest replays of
        # the captured step) launches its kernels once
        want = {k: 0 for k in KV_KERNEL.values()}
        want["fused_decode"] = steps if fused and kv_bits is None else 0
        if kv_kernel:
            want[kv_kernel] = n_layers * steps
        expect(name, counts, want, total)
    # (w1): a 64-frame clip (the JAX package's max_frames) makes the
    # prompt ~8.2k tokens, so the cache reaches 8192 rows: K4 on every
    # layer of every prefill chunk, K1 on its linears, K3 every step
    name = "(w1) 64-frame 448x448 clip + short prompt"
    counts, n, S, steps = run_video(
        model, proc, cfg, name, "K3", "Describe what happens in the video.",
        _clip(64, 448), None, 16)
    chunks = prefill_chunks(S, 16)
    want = {k: 0 for k in counts}
    want.update(fused_decode=steps, int4_matvec=1,
                int4_matmul=7 * n_layers * chunks,
                flash_attention=n_layers * chunks)
    expect(name, counts, want, total)
    del os.environ["MLX_VLM_TPU_FUSED_DECODE"]
    decide_fused_decode(model)
    time_full_step(model)
    # (i)'s texts name every token, so that they can be held to a run
    naming = _processor(name_ids=True)
    texts = run_batch_generate(model, naming, cfg, total)
    batch_vs_single(model, naming, cfg, texts)
    run_batch_generator(model, proc, cfg, total)
    run_server(model, cfg, total)
    run_apc(model, cfg, total)
    run_speculative(model, cfg, total)
    del model
    torch.cuda.empty_cache()
    exact_requests(proc, cfg, weights, ckpts.pop("qwen2_vl_7b_8bit"), total)
    run_qwen2_5_vl(ckpts["qwen2_5_vl_7b"], total)
    run_qwen3_vl(ckpts["qwen3_vl_8b"], total)
    t0 = time.perf_counter()
    run_llama_lora(sliced(ckpts["llama_3_1_8b"], 2), total)
    print(f"  run_llama_lora: {time.perf_counter() - t0:.1f} s", flush=True)
    for run, name in ((run_qwen3_vl_moe, "qwen3_vl_moe_30b_a3b"),
                      (run_llama, "llama_3_1_8b"),
                      (run_llava, "llava_1_5_7b"),
                      (run_qwen3_moe, "qwen3_30b_a3b"),
                      (run_mixtral, "mixtral_8x7b"),
                      (run_paligemma2, "paligemma2_3b"),
                      (run_paligemma, "paligemma_3b"),
                      (run_gpt_oss, "gpt_oss_20b"),
                      (run_phi_2, "phi_2")):
        t0 = time.perf_counter()
        run(ckpts.pop(name), total)
        print(f"  {run.__name__}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"  kernel launches on the main path: {total}", flush=True)
    for k, v in total.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
    return total


def load_timed(name: str, cfg: dict, weights: dict, mode=None):
    """load_model_from_weights onto the card in bf16 with
    MLX_VLM_TPU_RUNTIME_QUANT=`mode`, its seconds and memory printed."""
    import torch

    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights

    t0 = time.perf_counter()
    with env_vars(MLX_VLM_TPU_RUNTIME_QUANT=mode):
        model = load_model_from_weights(cfg, weights, torch.bfloat16, "cuda")
    lm = model.language_model
    layers = model.params["language_model"]["model"]["layers"]
    kind = type(layers.get("self_attn", layers.get("attn"))["q_proj"][
        "weight"]).__name__
    print(f"  {name}: loaded (fold + stack + upload) in "
          f"{time.perf_counter() - t0:.1f} s, {kind} linears, fused route "
          f"{lm.fused_decode}, {lm.args.num_hidden_layers} decoder layers, "
          f"vision depth {vision_depth(model)}; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    return model


def exact_want(counts: dict, n_layers: int, chunks: int, heads: int,
               steps: int, flash: int = 0) -> dict:
    """Launches of an exact-mode 4-bit model: K5 on each linear of each
    prefill chunk and each decode step and on each head (prefill heads and
    one a step), K4 `flash` times, every other kernel 0."""
    want = {k: 0 for k in counts}
    want["qmatmul_int4"] = 7 * n_layers * (chunks + steps) + heads + steps
    want["flash_attention"] = flash
    return want


def load_exact(name: str, ckpt: tuple):
    """A 4-bit checkpoint loaded exact (load_timed), its head checked to be
    K5's mlx codes and the fused route off: (model, config, decoder
    layers, the model's processor)."""
    cfg, weights = ckpt
    model = load_timed(name, cfg, weights, mode="exact")
    head = model.params["language_model"]["lm_head"]["weight"]
    if type(head).__name__ != "QuantizedTensor" or \
            model.language_model.fused_decode:
        fail(f"{name} did not load exact 4-bit weights")
    return (model, cfg, model.language_model.args.num_hidden_layers,
            _processor(model=model))


def run_exact_requests(model, proc, cfg, L: int, requests, total) -> None:
    """`requests` (name, text, image size or None, max tokens, kv_bits)
    through run_request on an exact model, each held to exact_want: K5 on
    every linear and head, K4 on every layer of every chunk where the
    cache reaches 8192 rows, K6 on every layer and step at kv_bits 4."""
    for name, text, size, max_tokens, kv_bits in requests:
        counts, n, S, steps = run_request(
            model, proc, cfg, name, "per-linear, qmatmul_int4"
            + (", int4_kv_attention" if kv_bits else ""), text,
            None if size is None else _image(size), int(size is not None),
            max_tokens, kv_bits, {})
        chunks = prefill_chunks(S, max_tokens)
        capacity = -(-(S + max_tokens + min(32, max_tokens) + 1) // 256) * 256
        flash = L * chunks if capacity >= 8192 and not kv_bits else 0
        want = exact_want(counts, L, chunks, 1, steps, flash)
        if kv_bits == 4:
            want["int4_kv_attention"] = L * steps
        expect(name, counts, want, total)


def exact_batch_want(counts: dict, L: int, st: dict) -> dict:
    """Launches of an exact model's batch run: K5 on every linear of each
    prefill chunk and batch step, on each prefill head and each step's
    head; every other kernel 0."""
    want = {k: 0 for k in counts}
    want["qmatmul_int4"] = (7 * L * st["prefill_chunks"]
                            + st["prefill_heads"] + (7 * L + 1) * st["steps"])
    return want


def run_video(model, proc, cfg, name: str, route: str, text: str,
              frames, image, max_tokens: int) -> tuple:
    """A clip (and an image before it) through run_request, after its host
    work is timed alone: prepare_inputs (the preprocessing: the frames'
    patches, the prompt's tokens), the vision cache's key and the prefix
    cache's salt of its arrays (the two hashes).  After the request the
    vision tower runs again on the clip's patches, already on the card,
    between CUDA events (two runs; each waits once on the host, where the
    tower reads its frame groups' layout).  Returns run_request's tuple."""
    import torch

    from mlx_vlm_tpu_torch.apc import prompt_key
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs
    from mlx_vlm_tpu_torch.vision_cache import VisionFeatureCache

    prompt = video_prompt(proc, cfg, text, frames, image is not None)
    t0 = time.perf_counter()
    inputs = prepare_inputs(proc, prompt, images=image, videos=frames,
                            fps=VIDEO_FPS)
    t1 = time.perf_counter()
    pv, grid = inputs["pixel_values_videos"], inputs["video_grid_thw"]
    VisionFeatureCache.key(pv, grid)
    t2 = time.perf_counter()
    prompt_key(model, inputs)
    t3 = time.perf_counter()
    out = run_request(model, proc, cfg, name, route, text, image,
                      int(image is not None), max_tokens, None, {},
                      video=frames, prompt=prompt)
    dev = model.device
    aux = {k: torch.from_numpy(np.asarray(v)).to(dev)
           for k, v in model.vision_aux_inputs(grid).items()}
    pix = torch.from_numpy(pv).to(dev)
    run = getattr(model, "vision_features", None) or model.tower_features
    tower_ms = _events_ms(lambda: run(model.params, pix, **aux), 2)
    del pix, aux
    print(f"    {name}: {len(frames)} frames of {frames.shape[2]}x"
          f"{frames.shape[1]}, video grid {grid.tolist()} ({pv.shape[0]} "
          f"patches, {pv.nbytes / 1e6:.1f} MB of pixel_values_videos); "
          f"host: preprocessing {t1 - t0:.4f} s, vision-cache key "
          f"{t2 - t1:.4f} s, prefix-cache salt {t3 - t2:.4f} s; the vision "
          f"tower on the clip {tower_ms:.4f} ms on the device (CUDA events, "
          f"mean of 2)", flush=True)
    return out


def serve_chat(model, proc, cfg, label: str, title: str, text: str, size,
               want, total: dict) -> None:
    """One chat of 16 tokens (with a size x size image, where `size`)
    through serve_requests; prints its metrics and holds its answer and
    launches (want(counts, generator stats)) to what ran."""
    req = (label, "chat", text, size, False, False, None, 16)
    answers, _, _, _, counts, st, metrics, wall, _, http = serve_requests(
        model, proc, cfg, [req], None)
    ans = answers.get(label) or {}
    env = (metrics.get("recent") or [{}])[-1]
    what = "chat" if size is None else "image chat ({})".format(
        "a PNG data URI over HTTP" if http else "through the engine")
    print(f"  {label} {title} server, {what}: status "
          f"{ans.get('status')}, {ans.get('completion')} tokens, finish "
          f"{ans.get('finish')}, {wall:.4f} s; /metrics ttft_s "
          f"{env.get('ttft_s')}, generation_tps "
          f"{env.get('generation_tps')}; {st['steps']} batch steps, "
          f"{st['prefill_chunks']} prefill chunks; launches {counts}",
          flush=True)
    if ans.get("status") != 200 or ans.get("errors") or not (
            ans.get("completion") == 16 or ans.get("finish") == "stop"):
        fail(f"{label}: answer {ans}")
    expect(label, counts, want(counts, st), total)


def run_qwen2_5_vl(ckpt: tuple, total: dict) -> None:
    """Qwen2.5-VL-7B at full width and depth (28 decoder layers, the 32-block
    windowed tower), default w4grp: (n1) an image request of 100 tokens
    (K1 on the prefill, K3 every decode step), (n2) batch_generate of
    BATCH_PROMPTS (text and image prompts admitted together), (n3) one
    image chat through the server."""
    import torch

    cfg, weights = ckpt
    model = load_timed("Qwen2.5-VL-7B (n1)-(n3)", cfg, weights)
    if not model.language_model.fused_decode:
        fail("Qwen2.5-VL-7B did not take the fused decode route")
    L = model.language_model.args.num_hidden_layers
    proc = _processor(model=model)
    name = "(n1) Qwen2.5-VL-7B, image 448x448 + short prompt"
    counts, n, S, steps = run_request(
        model, proc, cfg, name, "K3", "Describe this image in detail.",
        _image(448), 1, 100, None, {})
    want = {k: 0 for k in counts}
    want.update(fused_decode=steps, int4_matvec=1,
                int4_matmul=7 * L * prefill_chunks(S, 100))
    expect(name, counts, want, total)
    name = "(w2) Qwen2.5-VL-7B, image 448x448 + 16-frame 448x448 clip"
    counts, n, S, steps = run_video(
        model, proc, cfg, name, "K3", "Compare the image with the video.",
        _clip(16, 448), _image(448), 32)
    want = {k: 0 for k in counts}
    want.update(fused_decode=steps, int4_matvec=1,
                int4_matmul=7 * L * prefill_chunks(S, 32))
    expect(name, counts, want, total)
    run_batch_generate(model, proc, cfg, total,
                       name="(n2) Qwen2.5-VL-7B batch_generate")
    serve_chat(model, proc, cfg, "(n3)", "Qwen2.5-VL-7B",
               "Describe this image in detail.", 448, lambda c, st: dict(
                   {k: 0 for k in c}, int4_matmul=7 * L * st[
                       "prefill_chunks"], int4_matvec=(7 * L + 1) * st[
                       "steps"] + st["prefill_heads"]), total)
    del model
    torch.cuda.empty_cache()


def run_qwen3_vl(ckpt: tuple, total: dict) -> None:
    """Qwen3-VL-8B at full width and depth (36 decoder layers, the 27-block
    deepstack tower), MLX_VLM_TPU_RUNTIME_QUANT=exact (K5 on every linear
    and the head): (q1) an image request, (q2) an image and a ~8.5k-token
    prompt (K4 on every layer of every prefill chunk), (q3) batch_generate
    of a text prompt and an image prompt admitted together (rows of widths
    D and 4D in one admission)."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template, batch_generate

    model, cfg, L, proc = load_exact("Qwen3-VL-8B (q1)-(q3)", ckpt)
    run_exact_requests(model, proc, cfg, L, (
        ("(q1) Qwen3-VL-8B exact, image 448x448 + short prompt",
         "Describe this image in detail.", 448, 32, None),
        ("(q2) Qwen3-VL-8B exact, image + ~8.5k-token prompt", LONG_TEXT,
         448, 16, None)), total)
    name = "(w3) Qwen3-VL-8B exact, 16-frame 448x448 clip with timestamps"
    counts, n, S, steps = run_video(
        model, proc, cfg, name, "per-linear, qmatmul_int4",
        "What happens in this video?", _clip(16, 448), None, 32)
    expect(name, counts, exact_want(counts, L, prefill_chunks(S, 32), 1,
                                    steps), total)
    name = "(q3) Qwen3-VL-8B exact, batch_generate: a text and an image row"
    prompts = [apply_chat_template(proc, cfg, t, num_images=k) for t, k in (
        ("Write a short story about a lighthouse.", 0),
        ("What is in this image?", 1))]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = batch_generate(model, proc, prompts, images=[None, _image(448)],
                         max_tokens=24, num_slots=2)
    counts = read_counts()
    st = res.generator_stats
    n_gen = res.stats["generation_tokens"]
    print(f"  {name}: {res.stats['prompt_tokens']} prompt tokens, {n_gen} "
          f"tokens in {res.stats['wall_s']:.4f} s "
          f"({n_gen / res.stats['wall_s']:.2f} tok/s aggregate); "
          f"{st['admissions']} admission(s), {st['prefill_chunks']} prefill "
          f"chunks, {st['steps']} batch steps ({st['replays']} replays); "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {counts}", flush=True)
    if st["admissions"] != 1 or not 0 < n_gen <= 48:
        fail(f"{name}: want both rows in one admission, stats {st}")
    expect(name, counts, exact_batch_want(counts, L, st), total)
    del model
    torch.cuda.empty_cache()


def profile_prefill(model, proc, cfg, text: str) -> None:
    """With --profile: one eager prefill of `text` and a 448x448 image (the
    embedding and tower, then the language model in one chunk into a fresh
    cache) timed on the host three times, then traced (print_profile): the
    share of its wall time the card is busy."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.generate.ar import make_cache
    from mlx_vlm_tpu_torch.generate.common import embed_prompt
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs

    inputs = prepare_inputs(proc, apply_chat_template(proc, cfg, text,
                                                      num_images=1),
                            images=_image(448))
    lm, lp = model.language_model, model.params["language_model"]

    def prefill():
        embeds, pos, _ = embed_prompt(model, inputs)
        cache = make_cache(model, 1, -(-embeds.shape[1] // 256) * 256,
                           embeds.dtype, None, device=model.device)
        lm(lp, embeds, cache,
           torch.from_numpy(pos.astype(np.int64)).to(model.device))

    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        print(f"    eager prefill of {inputs['input_ids'].shape[1]} tokens: "
              f"{time.perf_counter() - t0:.4f} s of wall time", flush=True)
    print_profile(prefill, "eager prefills")


def run_qwen3_vl_moe(ckpt: tuple, total: dict) -> None:
    """Qwen3-VL-30B-A3B at full width (MOE_LAYERS of its 48 decoder layers
    of 128 experts, top-8; the 27-block deepstack tower), the loader's
    default mode (w8chan linears and 8-bit routers, the expert stacks exact
    on K5):
    (u1) an image request of 64 tokens through stream_generate on decode
    blocks, (u2) BATCH_PROMPTS through batch_generate in 4 slots, (u3) an
    image chat through the server, (u4) an image and a ~8.5k-token prompt
    (K4 on every layer of every chunk).  Each request's expert layers are
    held to `moe_want` (decode steps and short chunks one expert-indexed
    launch a projection, long chunks K5 per expert with rows)."""
    import torch

    from mlx_vlm_tpu_torch.core import moe

    cfg, weights = ckpt
    model = load_timed("Qwen3-VL-30B-A3B (u1)-(u4)", cfg, weights)
    lm = model.language_model
    layers = model.params["language_model"]["model"]["layers"]
    experts = layers["mlp"]["experts"]["gate_proj"]["weight"]
    router = layers["mlp"]["gate"]["weight"]
    if (type(experts).__name__ != "QuantizedTensor" or experts.bits != 4
            or tuple(experts.shape[:2]) != (MOE_LAYERS, 128)
            or type(router).__name__ != "ChannelQuantizedTensor"
            or router.src_bits != 8 or lm.top_k != 8):
        fail(f"Qwen3-VL-30B-A3B did not load 4-bit expert stacks "
             f"[{MOE_LAYERS}, 128, "
             "...] on K5 beside w8chan linears and 8-bit routers, top-8")
    L = lm.args.num_hidden_layers
    proc = _processor(model=model)
    for name, text, max_tokens in (
            ("(u1) Qwen3-VL-30B-A3B, image 448x448 + short prompt",
             "Describe this image in detail.", 64),
            ("(u4) Qwen3-VL-30B-A3B, image + ~8.5k-token prompt", LONG_TEXT,
             16)):
        counts, n, S, steps = run_request(
            model, proc, cfg, name, "per-linear, experts on K5", text,
            _image(448), 1, max_tokens, None, {})
        chunks = prefill_chunks(S, max_tokens)
        capacity = -(-(S + max_tokens + min(32, max_tokens) + 1) // 256) * 256
        want = moe_want(counts, L, chunks + steps)
        want["flash_attention"] = L * chunks if capacity >= 8192 else 0
        calls, runs = moe.stats["grouped_calls"], moe.stats["grouped_experts"]
        print(f"    {name}: prefill route on {calls} layer calls, {runs} "
              f"expert runs ({runs / max(1, calls):.1f} experts a layer "
              f"and chunk)", flush=True)
        expect(name, counts, want, total)
        if PROFILE and max_tokens == 64:
            profile_prefill(model, proc, cfg, text)
    run_batch_generate(model, proc, cfg, total,
                       "(u2) Qwen3-VL-30B-A3B batch_generate",
                       want=batch_moe_want(L))
    serve_chat(model, proc, cfg, "(u3)", "Qwen3-VL-30B-A3B",
               "Describe this image in detail.", 448, batch_moe_want(L),
               total)
    del model, experts, router, layers
    torch.cuda.empty_cache()


def run_llama(ckpt: tuple, total: dict) -> None:
    """Llama-3.1-8B at full width and depth (32 layers, its llama3 rope
    scaling), text only, MLX_VLM_TPU_RUNTIME_QUANT=exact (K5 on every
    linear and the head): (t1) a short chat of 32 tokens, then the same
    prompt with kv_bits=4, 16 tokens (K6 on every layer and step); (t2) a
    ~8.5k-token prompt, 16 tokens (K4 on every layer of every prefill
    chunk); (t3) batch_generate of BATCH_PROMPTS' texts in 4 slots."""
    import torch

    model, cfg, L, proc = load_exact("Llama-3.1-8B (t1)-(t3)", ckpt)
    chat = "Write a short story about a lighthouse."
    run_exact_requests(model, proc, cfg, L, (
        ("(t1) Llama-3.1-8B exact, short chat", chat, None, 32, None),
        ("(t1) Llama-3.1-8B exact, short chat, kv_bits 4", chat, None, 16,
         4),
        ("(t2) Llama-3.1-8B exact, ~8.5k-token prompt", LONG_TEXT, None, 16,
         None)), total)
    run_batch_generate(model, proc, cfg, total,
                       "(t3) Llama-3.1-8B exact, batch_generate",
                       with_images=False,
                       want=lambda c, st: exact_batch_want(c, L, st))
    run_drafters(model, cfg, total)
    del model
    torch.cuda.empty_cache()


def run_llava(ckpt: tuple, total: dict) -> None:
    """LLaVA-1.5-7B at full width and depth (32 decoder layers, the
    24-block CLIP ViT-L/14-336 tower), exact: (v1) a 336x336 image and a
    short prompt, 32 tokens; (v2) one image chat through the server.  Its
    4096-position context keeps K4 out."""
    import torch

    model, cfg, L, proc = load_exact("LLaVA-1.5-7B (v1)-(v2)", ckpt)
    run_exact_requests(model, proc, cfg, L, (
        ("(v1) LLaVA-1.5-7B exact, image 336x336 + short prompt",
         "Describe this image in detail.", 336, 32, None),), total)
    serve_chat(model, proc, cfg, "(v2)", "LLaVA-1.5-7B",
               "Describe this image in detail.", 336,
               lambda c, st: exact_batch_want(c, L, st), total)
    del model
    torch.cuda.empty_cache()


def load_paligemma(name: str, ckpt: tuple, mode=None):
    """A 4-bit PaliGemma checkpoint loaded by load_timed in `mode` (None:
    the default, w8chan; "exact": K5), its tied table checked to be in
    that layout: (model, decoder layers, the model's processor)."""
    cfg, weights = ckpt
    model = load_timed(name, cfg, weights, mode=mode)
    table = model.params["language_model"]["model"]["embed_tokens"]["weight"]
    want = "QuantizedTensor" if mode == "exact" else "ChannelQuantizedTensor"
    if type(table).__name__ != want or model.language_model.fused_decode:
        fail(f"{name}: its tied table loaded as {type(table).__name__}, "
             f"want {want}")
    return model, model.language_model.args.num_hidden_layers, \
        _processor(model=model)


def paligemma_requests(model, proc, cfg, L: int, requests,
                       total: dict) -> None:
    """`requests` (name, text, max tokens, kv_bits) on a PaliGemma model,
    each with a 224 x 224 image, through run_request: K5 on every linear
    and head in exact (exact_want, K4 never: the prefix keeps `flash_ok`
    False), no kernel in w8chan, K6 once a layer and decode step at
    kv_bits 4; every other counter 0.  Prints the layers that take the
    sliding mask and whether the cache reached past the window."""
    lm = model.language_model
    exact = type(model.params["language_model"]["model"]["layers"][
        "self_attn"]["q_proj"]["weight"]).__name__ == "QuantizedTensor"
    for name, text, max_tokens, kv_bits in requests:
        counts, n, S, steps = run_request(
            model, proc, cfg, name, ("per-linear, qmatmul_int4" if exact
                                     else "per-linear, w8chan")
            + (", int4_kv_attention" if kv_bits else ""), text, _image(224),
            1, max_tokens, kv_bits, {})
        chunks = prefill_chunks(S, max_tokens)
        want = (exact_want(counts, L, chunks, 1, steps) if exact
                else {k: 0 for k in counts})
        if kv_bits == 4:
            want["int4_kv_attention"] = L * steps
        sliding = lm.is_full.count(False)
        past = sliding and S > lm.args.sliding_window
        print(f"    {name}: {sliding} of {L} layers take the sliding mask "
              f"(window {lm.args.sliding_window}); the prompt's {S} tokens "
              f"and {steps} steps reach row {S + steps - 1}"
              f"{', past the window' if past else ''}", flush=True)
        expect(name, counts, want, total)


PALIGEMMA_CHAT = "Describe this image in detail."


def run_paligemma2(ckpt: tuple, total: dict) -> None:
    """PaliGemma2-3B at full width and depth (26 layers, the 27-block
    SigLIP tower): (p1) a 224 x 224 image and a short prompt, 32 tokens,
    in the default mode (w8chan: no kernel) and exact (K5, no K4); (p2)
    exact, an image and a ~8.5k-token prompt, 16 tokens (the chunked
    bidirectional prefill, the 4096 window at decode).  Its prefix keeps
    prefix caching off (`model_apc_mode` None)."""
    import torch

    from mlx_vlm_tpu_torch.apc_adapters import model_apc_mode

    cfg = ckpt[0]
    for mode in (None, "exact"):
        label = "exact" if mode else "default (w8chan)"
        model, L, proc = load_paligemma(f"PaliGemma2-3B {label} (p1)"
                                        + (", (p2)" if mode else ""),
                                        ckpt, mode)
        if model_apc_mode(model) is not None:
            fail("PaliGemma2-3B: prefix caching is on for a bidirectional "
                 "prefix")
        requests = [(f"(p1) PaliGemma2-3B {label}, image 224x224 + short "
                     f"prompt", PALIGEMMA_CHAT, 32, None)]
        if mode:
            requests.append(("(p2) PaliGemma2-3B exact, image + ~8.5k-token "
                             "prompt", LONG_TEXT, 16, None))
        paligemma_requests(model, proc, cfg, L, requests, total)
        del model
        torch.cuda.empty_cache()


def run_paligemma(ckpt: tuple, total: dict) -> None:
    """PaliGemma-3B at full width and depth (18 layers) exact: (p3) an
    image and a short prompt at kv_bits 4, 16 tokens (K6 once a layer and
    step, head dim 256 over one KV head)."""
    import torch

    model, L, proc = load_paligemma("PaliGemma-3B exact (p3)", ckpt, "exact")
    paligemma_requests(model, proc, ckpt[0], L, [
        ("(p3) PaliGemma-3B exact, image 224x224 + short prompt, kv_bits 4",
         PALIGEMMA_CHAT, 16, 4)], total)
    del model
    torch.cuda.empty_cache()


def moe_exact_want(counts: dict, L: int, forwards: int, heads: int) -> dict:
    """Launches of an exact-mode text MoE model over `forwards` forward
    passes (prefill chunks and decode steps) and `heads` head rows
    (prefill heads and one a step): its expert layers by `moe_want`, K5
    on the 4 attention linears of each layer and forward and on each head
    (4 bits), and on each layer's router (8 bits)."""
    want = moe_want(counts, L, forwards)
    want["qmatmul_int4"] += 4 * L * forwards + heads
    want["qmatmul_int8"] = L * forwards
    return want


def run_moe_requests(model, proc, cfg, requests, total: dict,
                     exact: bool = False) -> None:
    """`requests` (name, text, max tokens, kv_bits) through run_request on
    a text MoE model, each held to what ran: its expert layers by
    `moe_want` (and, `exact`, every linear, router and head on K5:
    `moe_exact_want`), K4 on every layer of every chunk where the cache
    reaches 8192 rows, K6 on every layer and step at kv_bits 4.  A long
    prompt's chunks (more than PREFILL_MIN_TOKENS rows each) must take the
    prefill route on every layer."""
    from mlx_vlm_tpu_torch.core import moe

    L = model.language_model.args.num_hidden_layers
    for name, text, max_tokens, kv_bits in requests:
        route = ("per-linear" + (", qmatmul_int4" if exact else "")
                 + ", experts on K5"
                 + (", int4_kv_attention" if kv_bits else ""))
        counts, n, S, steps = run_request(model, proc, cfg, name, route, text,
                                          None, 0, max_tokens, kv_bits, {})
        chunks = prefill_chunks(S, max_tokens)
        capacity = -(-(S + max_tokens + min(32, max_tokens) + 1) // 256) * 256
        want = (moe_exact_want(counts, L, chunks + steps, 1 + steps) if exact
                else moe_want(counts, L, chunks + steps))
        want["flash_attention"] = (L * chunks if capacity >= 8192
                                   and not kv_bits else 0)
        if kv_bits == 4:
            want["int4_kv_attention"] = L * steps
        calls, runs = moe.stats["grouped_calls"], moe.stats["grouped_experts"]
        print(f"    {name}: prefill route on {calls} layer calls, {runs} "
              f"expert runs ({runs / max(1, calls):.1f} experts a layer and "
              f"chunk)", flush=True)
        if text is LONG_TEXT and calls != L * chunks:
            fail(f"{name}: the prefill route took {calls} layer calls, want "
                 f"{L} layers x {chunks} chunks")
        expect(name, counts, want, total)


def load_moe_text(name: str, ckpt: tuple, mode=None):
    """A text MoE checkpoint loaded onto the card (load_timed), checked to
    hold 4-bit expert stacks [L, E, ...] exact for K5 beside 8-bit routers
    (per-channel int8 by default, K5's codes in exact)."""
    cfg, weights = ckpt
    model = load_timed(name, cfg, weights, mode=mode)
    lm = model.language_model
    mlp = model.params["language_model"]["model"]["layers"]["mlp"]
    experts, router = (mlp["experts"]["gate_proj"]["weight"],
                       mlp["gate"]["weight"])
    E = cfg.get("num_experts") or cfg["num_local_experts"]
    router_kind = "QuantizedTensor" if mode == "exact" else \
        "ChannelQuantizedTensor"
    if (type(experts).__name__ != "QuantizedTensor" or experts.bits != 4
            or tuple(experts.shape[:2]) != (lm.args.num_hidden_layers, E)
            or type(router).__name__ != router_kind
            or getattr(router, "bits", getattr(router, "src_bits", 0)) != 8
            or lm.top_k != cfg["num_experts_per_tok"]):
        fail(f"{name} did not load 4-bit expert stacks [L, {E}, ...] on K5 "
             f"beside 8-bit routers ({router_kind}), top-"
             f"{cfg['num_experts_per_tok']}")
    return model, cfg, lm.args.num_hidden_layers, _processor(model=model)


def run_qwen3_moe(ckpt: tuple, total: dict) -> None:
    """Qwen3-30B-A3B at full width (QWEN3_MOE_LAYERS of its 48 decoder
    layers of 128 experts, top-8), text only, the loader's default mode
    (w8chan linears and 8-bit routers, the expert stacks exact on K5): (x1)
    a short chat of 64 tokens; (x2) a ~8.3k-token prompt, 16 tokens (K4
    and the prefill route on every layer of every chunk); (x3)
    BATCH_PROMPTS' texts through batch_generate in 4 slots; (x4) one chat
    through the server; (x5) (x1)'s prompt at kv_bits=4, 16 tokens (K6 on
    every layer and step).  Each request's expert layers are held to
    `moe_want`."""
    import torch

    model, cfg, L, proc = load_moe_text("Qwen3-30B-A3B (x1)-(x5)", ckpt)
    if type(model).__module__ != "mlx_vlm_tpu_torch.models.qwen2_moe." \
                                 "qwen2_moe":
        fail("qwen3_moe did not load as the Qwen-MoE decoder")
    chat = "Write a short story about a lighthouse."
    run_moe_requests(model, proc, cfg, (
        ("(x1) Qwen3-30B-A3B, short chat", chat, 64, None),
        ("(x2) Qwen3-30B-A3B, ~8.3k-token prompt", LONG_TEXT, 16, None),
        ("(x5) Qwen3-30B-A3B, short chat, kv_bits 4", chat, 16, 4)), total)
    run_batch_generate(model, proc, cfg, total,
                       "(x3) Qwen3-30B-A3B batch_generate",
                       with_images=False,
                       want=batch_moe_want(L))
    serve_chat(model, proc, cfg, "(x4)", "Qwen3-30B-A3B", chat, None,
               batch_moe_want(L), total)
    del model
    torch.cuda.empty_cache()


def run_mixtral(ckpt: tuple, total: dict) -> None:
    """Mixtral-8x7B at its published widths and MIXTRAL_LAYERS of its 32
    decoder layers (8 experts of width 14336, top-2): (y1) a short chat of
    32 tokens in the default mode (w8chan linears and 8-bit routers, the
    experts on K5) and in exact (every linear, router and head on K5), each
    on its own load."""
    import torch

    chat = "Write a short story about a lighthouse."
    for mode in (None, "exact"):
        label = "exact" if mode else "default"
        model, cfg, _, proc = load_moe_text(f"Mixtral-8x7B (y1) {label}",
                                            ckpt, mode)
        run_moe_requests(model, proc, cfg, (
            (f"(y1) Mixtral-8x7B {label}, short chat", chat, 32, None),),
            total, exact=mode == "exact")
        del model
        torch.cuda.empty_cache()


def run_gpt_oss(ckpt: tuple, total: dict) -> None:
    """gpt-oss-20b at its published widths and GPT_OSS_LAYERS of its 24
    decoder layers (two sliding, window 128, and two full; sinks on every
    layer), text only.  Exact: (o1) a short chat of 32 tokens; (o2) a
    ~8.5k-token prompt, 16 tokens (the window and the sinks over a long
    cache; the experts' prefill route on every layer of every chunk).  The
    default mode (w8chan linears, router and head; the expert stacks exact
    on K5): (o3) the short chat, 16 tokens.  Each on its load, each
    request's launches held to what ran: K5 on o (4 bits; q / k / v, the
    router and the head take the dequantize route at K = 2880) in exact,
    the experts by `gpt_oss_experts_want`, and no attention kernel (K4 is
    refused, K6-K8 by the sinks)."""
    import torch

    from mlx_vlm_tpu_torch.core import moe

    cfg, weights = ckpt
    chat = "Write a short story about a lighthouse."
    for mode, requests in (
            ("exact", (("(o1) gpt-oss-20b exact, short chat", chat, 32),
                       ("(o2) gpt-oss-20b exact, ~8.5k-token prompt",
                        LONG_TEXT, 16))),
            (None, (("(o3) gpt-oss-20b default, short chat", chat, 16),))):
        label = "exact" if mode else "default"
        model = load_timed(f"gpt-oss-20b {label}", cfg, weights, mode=mode)
        lm = model.language_model
        L = lm.args.num_hidden_layers
        lay = model.params["language_model"]["model"]["layers"]
        experts = lay["mlp"]["experts"]["gate_proj"]["weight"]
        q = lay["self_attn"]["q_proj"]["weight"]
        if (type(experts).__name__ != "QuantizedTensor" or experts.bits != 4
                or tuple(experts.shape[:2]) != (L, 32)
                or type(q).__name__ != ("QuantizedTensor" if mode else
                                        "ChannelQuantizedTensor")
                or lm.is_full != [False, True] * (L // 2)):
            fail(f"gpt-oss-20b {label} did not load 4-bit expert stacks "
                 f"[L, 32, ...] beside its mode's linears, sliding and full "
                 f"layers alternating")
        proc = _processor(model=model)
        for name, text, max_tokens in requests:
            counts, n, S, steps = run_request(
                model, proc, cfg, name, "per-linear, experts on K5"
                + (", o on qmatmul_int4" if mode else ""), text, None, 0,
                max_tokens, None, {})
            chunks = prefill_chunks(S, max_tokens)
            want = gpt_oss_experts_want({k: 0 for k in counts}, L,
                                        chunks + steps)
            if mode:
                want["qmatmul_int4"] = L * (chunks + steps)
            calls, runs = (moe.stats["grouped_calls"],
                           moe.stats["grouped_experts"])
            print(f"    {name}: prefill route on {calls} layer calls, {runs} "
                  f"expert runs", flush=True)
            if text is LONG_TEXT and calls != L * chunks:
                fail(f"{name}: the prefill route took {calls} layer calls, "
                     f"want {L} layers x {chunks} chunks")
            expect(name, counts, want, total)
        del model
        torch.cuda.empty_cache()


# (r2)'s prompt: LONG_TEXT's first 1,850 characters, ~1.9k tokens with the
# chat template, inside phi-2's 2,048 positions
PHI_2_TEXT = LONG_TEXT[:1850]


def run_phi_2(ckpt: tuple, total: dict) -> None:
    """phi-2 at its published widths and depth (32 layers), exact (K5 on
    q / k / v / dense / fc1 / fc2 and the biased head): (r1) a short chat of
    32 tokens; (r2) a ~1.9k-token prompt, 16 tokens.  Each request's
    launches: K5 on 6 linears a layer of each chunk and step and on each
    head, nothing else (the classic decoder attends through `sdpa`)."""
    import torch

    cfg, weights = ckpt
    model = load_timed("phi-2 (r1), (r2)", cfg, weights, mode="exact")
    lm = model.language_model
    L = lm.args.num_hidden_layers
    head = model.params["language_model"]["lm_head"]
    if (type(head["weight"]).__name__ != "QuantizedTensor" or L != 32
            or "bias" not in head or lm.rope_dim != 32):
        fail("phi-2 did not load exact at 32 layers with its biased head "
             "and 32 rotated lanes")
    proc = _processor(model=model)
    chat = "Write a short story about a lighthouse."
    for name, text, max_tokens in (
            ("(r1) phi-2 exact, short chat", chat, 32),
            ("(r2) phi-2 exact, ~1.9k-token prompt", PHI_2_TEXT, 16)):
        counts, n, S, steps = run_request(model, proc, cfg, name,
                                          "per-linear, qmatmul_int4", text,
                                          None, 0, max_tokens, None, {})
        chunks = prefill_chunks(S, max_tokens)
        want = {k: 0 for k in counts}
        want["qmatmul_int4"] = 6 * L * (chunks + steps) + 1 + steps
        expect(name, counts, want, total)
    del model
    torch.cuda.empty_cache()


def run_llama_lora(ckpt: tuple, total: dict) -> None:
    """Llama-3.1-8B at its published widths and 2 of its 32 layers, exact,
    with a rank-16 LoRA on q / v written by `save_adapter` and attached by
    `apply_lora_layers` (trainer/lora.py): (r3) a short chat of 32 tokens,
    K5 on every base linear and the head (the adapter's rank-16 products
    are plain matmuls)."""
    import shutil
    import tempfile

    import torch

    from mlx_vlm_tpu_torch.trainer.lora import apply_lora_layers, save_adapter

    cfg, weights = ckpt
    model = load_timed("Llama-3.1-8B (r3)", cfg, weights, mode="exact")
    where = tempfile.mkdtemp()
    try:
        save_adapter(where, card_adapter(model, False, SEED + 22),
                     {"rank": ADAPTER_RANK})
        apply_lora_layers(model, where)
    finally:
        shutil.rmtree(where)
    q = model.params["language_model"]["model"]["layers"]["self_attn"][
        "q_proj"]
    L = model.language_model.args.num_hidden_layers
    if tuple(q["lora_a"].shape) != (L, ADAPTER_RANK, 4096) or not \
            q["lora_a"].is_cuda:
        fail("(r3): the adapter did not attach on the card")
    proc = _processor(model=model)
    name = "(r3) Llama-3.1-8B exact + LoRA r16 on q / v, short chat"
    counts, n, S, steps = run_request(
        model, proc, cfg, name, "per-linear, qmatmul_int4, LoRA",
        "Write a short story about a lighthouse.", None, 0, 32, None, {})
    expect(name, counts, exact_want(counts, L, prefill_chunks(S, 32), 1,
                                    steps), total)
    del model
    torch.cuda.empty_cache()


def exact_requests(proc, cfg4: dict, weights4: dict, ckpt8: tuple,
                   total: dict) -> None:
    """Requests (g) and (h): each on its own full-width model loaded with
    MLX_VLM_TPU_RUNTIME_QUANT=exact, so that every decoder linear (7 per
    layer) runs K5 for each prefill chunk and each decode step, and the
    lm_head once per token; no other weight kernel and no quantized-KV
    kernel runs.  (g) takes the 4-bit checkpoint, (h) `ckpt8`, the 8-bit
    one that `family_checkpoints` built."""
    import torch

    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights

    zero = ("int4_matmul", "int4_matvec", "fused_decode",
            "int4_kv_attention", "tq_kv_attention", "tq_kv_attention_split")
    requests = [  # (name, bits, text, image, images, max_tokens, kv_bits,
        #             MLX_VLM_TPU_KV_SCHEME)
        ("(g) exact 4-bit, image 448x448 + short prompt", 4,
         "Describe this image in detail.", _image(448), 1, 32, None, None),
        ("(h) exact 8-bit, text only, kv_bits 8 affine", 8,
         "Write a short story about a lighthouse.", None, 0, 32, 8, "affine"),
    ]
    for name, bits, text, image, n_img, max_tokens, kv_bits, scheme in \
            requests:
        cfg, weights = (cfg4, weights4) if bits == 4 else ckpt8
        t1 = time.perf_counter()
        with env_vars(MLX_VLM_TPU_RUNTIME_QUANT="exact"):
            model = load_model_from_weights(cfg, weights, torch.bfloat16,
                                            "cuda")
        del weights
        t2 = time.perf_counter()
        lp = model.params["language_model"]
        n_layers = model.language_model.args.num_hidden_layers
        head = lp["lm_head"]["weight"]
        if (type(head).__name__ != "QuantizedTensor" or head.bits != bits
                or model.language_model.fused_decode):
            fail(f"{name}: the model did not load exact {bits}-bit weights")
        print(f"  {name}: checkpoint built in phase 3, loaded in "
              f"{t2 - t1:.1f} s; device memory "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
        counts, n, S, steps = run_request(
            model, proc, cfg, name, f"per-linear, qmatmul_int{bits}", text,
            image, n_img, max_tokens, kv_bits,
            {"MLX_VLM_TPU_KV_SCHEME": scheme})
        want = {k: 0 for k in zero + ("qmatmul_int4", "qmatmul_int8")}
        want[f"qmatmul_int{bits}"] = (
            prefill_chunks(S, max_tokens) * 7 * n_layers + 1
            + steps * (7 * n_layers + 1))
        expect(name, counts, want, total)
        del model, lp, head
        torch.cuda.empty_cache()


# K3's 28-layer step at offsets 300 and 8545 when the host passed the
# offset (PERF.md's kernel table, NVIDIA H100 80GB HBM3 at 700 W), printed
# beside this run's
HOST_OFFSET_STEP_MS = (3.2420, 3.5668)


def time_full_step(model) -> None:
    """One 28-layer K3 step (with the int4 head) and its plain version on
    the loaded 7B model, at 300 and 8545 tokens of history."""
    import torch

    from mlx_vlm_tpu_torch.ops import fused_decode as fd

    lm = model.language_model
    lp = model.params["language_model"]
    dev = model.device
    cache = lm.init_cache(1, FUSED_CAPACITY, torch.bfloat16, device=dev)
    h = lm.embed(lp, torch.tensor([[42]], device=dev))
    for off, before in zip((300, 8545), HOST_OFFSET_STEP_MS):
        cos, sin = lm.rope.cos_sin(torch.full((3, 1, 1), off, device=dev))
        cache.offset.fill_(off)
        args = (lp, lm.args, h, cos[0, 0], sin[0, 0], cache.k, cache.v,
                cache.offset)
        ms = device_ms(lambda: fd.fused_decode_step(*args))
        plain_ms = device_ms(lambda: fd.fused_decode_step_plain(*args),
                             iters=3)
        call = call_ms(lambda: fd.fused_decode_step(*args))
        nbytes = fused_step_bytes(lp, lm.args, off)
        bound_ms, bound_by = bound(nbytes, fused_step_ops(lp, lm.args, off))
        plan = fd.step_plan(lp, lm.args, dev)
        print(f"  28-layer K3 step, offset {off} (cursor from the device "
              f"word): kernel_ms={ms:.4f} (offset passed by the host: "
              f"{before:.4f}) plain_ms={plain_ms:.4f} (device time) "
              f"kernel_call_ms={call:.4f}; {nbytes / 1e9:.3f} GB read, "
              f"{nbytes / ms / 1e9:.3f} TB/s; bound_ms={bound_ms:.4f} "
              f"({bound_by}, {bound_ms / ms:.1%} of it); {plan.barriers} grid "
              f"barriers, {plan.chunks_at(off)} attention chunks per kv head",
              flush=True)


KV_SHAPE = (f"BH={KV_HEADS} g={KV_ROWS} D={KV_DIM} C={KV_CAPACITY} "
            f"offset=8545 left_pad=0 q_scale=4")
KERNELS = (
    ("int4_matmul", "mlx_vlm_tpu_torch/csrc/int4_matmul.cu",
     "mlx_vlm_tpu/ops/int4_matvec.py:159", "M=512 K=3584 N=18944"),
    ("int4_matvec", "mlx_vlm_tpu_torch/csrc/int4_matvec.cu",
     "mlx_vlm_tpu/ops/int4_matvec.py:223", "M=1 K=3584 N=18944"),
    ("flash_attention", "mlx_vlm_tpu_torch/csrc/flash_attention.cu",
     "mlx_vlm_tpu/ops/flash_attention.py:89",
     "B=1 H=28 KVH=4 D=128 S=512 C=8192 offset=7680 left_pad=0 window=None "
     "q_scale=1"),
    ("fused_decode", "mlx_vlm_tpu_torch/csrc/fused_decode.cu",
     "mlx_vlm_tpu/ops/fused_decode.py:964",
     "L=4 D=3584 I=18944 H=28 KVH=4 V=152064 C=8704 offset=8545 q_scale=4"),
    ("qmatmul_int4", "mlx_vlm_tpu_torch/csrc/qmatmul.cu",
     "mlx_vlm_tpu/ops/qmatmul.py:53", "M=512 K=3584 N=18944 g=64"),
    ("qmatmul_int8", "mlx_vlm_tpu_torch/csrc/qmatmul.cu",
     "mlx_vlm_tpu/ops/qmatmul.py:83", "M=512 K=3584 N=18944 g=64"),
    ("qmatmul_experts", "mlx_vlm_tpu_torch/csrc/qmatmul.cu",
     "mlx_vlm_tpu/ops/qmatmul.py:53",
     f"P=8 E={MOE_EXPERTS} K=2048 N=768 g=64"),
    ("int4_kv_attention", "mlx_vlm_tpu_torch/csrc/int4_kv_attention.cu",
     "mlx_vlm_tpu/ops/int4_kv_attention.py:104", KV_SHAPE),
    ("tq_kv_attention", "mlx_vlm_tpu_torch/csrc/tq_kv_attention.cu",
     "mlx_vlm_tpu/ops/tq_kv_attention.py:115", KV_SHAPE),
    ("tq_kv_attention_split", "mlx_vlm_tpu_torch/csrc/tq_kv_attention.cu",
     "mlx_vlm_tpu/ops/tq_kv_attention.py:228", KV_SHAPE),
)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        clock.append(time.perf_counter())
        print(f"{phase}: {clock[-1] - clock[-2]:.1f} s", flush=True)

    phase_environment()
    lap("phase 1")
    results = phase_kernels()
    lap("phase 2")
    bad = [r for r in results if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks disagree with their plain versions")
    with fold_once() as folds:
        ckpts = family_checkpoints()
        check_fold_on_card(ckpts["llama_3_1_8b"])
        if not phase_slice_parity(ckpts["qwen2_vl_7b"]):
            fail("the slice on the card disagrees with the slice on the CPU")
        if not phase_quant_parity():
            fail("a runtime quantization mode on the card disagrees with the "
                 "CPU")
        if not phase_family_parity(ckpts):
            fail("Qwen2.5-VL or Qwen3-VL on the card disagrees with the CPU")
        t3 = time.perf_counter()
        if not phase_drafter_parity(ckpts["llama_3_1_8b"]):
            fail("a target-coupled drafter on the card disagrees with the "
                 "CPU")
        print(f"  drafter part: {time.perf_counter() - t3:.1f} s; "
              f"per-channel folds on the card so far: {folds.card[0]} in "
              f"{folds.card[1]:.1f} s", flush=True)
        lap("phase 3")
        launches = phase_main_path(ckpts)
        print(f"  per-channel folds on the card in phases 3-4: "
              f"{folds.card[0]} in {folds.card[1]:.1f} s", flush=True)
        lap("phase 4")
    report = []
    for name, source, replaces, shape in KERNELS:
        mine = [r for r in results if r["name"] == name]
        at = next(r for r in mine if r["shape"] == shape)
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "call_ms": at["call_ms"],
            "shape": shape})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
