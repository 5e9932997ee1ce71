"""cxxnet_tpu_torch: cxxnet-tpu ported to PyTorch and CUDA on Hopper.

A second package beside `cxxnet_tpu`, ported in slices:

1. Serving: the config parser and NetConfig DAG, the forward of the
   AlexNet layer set (conv, relu/sigmoid/tanh/softplus, max/sum/avg
   pooling, lrn, flatten, fullc, dropout, softmax/l2_loss/
   multi_logistic), checkpoints in the JAX package's byte format, the
   inference half of `NetTrainer`, the continuous-batching `Server`
   and the CLI tasks pred / pred_raw / serve. Kernel: K1-fwd, the LRN
   forward (`csrc/lrn_fwd.cu`).
2. Training: the updaters (`updater/`: SGD, NAG, Adam and their
   schedules), dropout with per-(seed, step, layer) generators, the
   loss layers' per-example losses, the tie-duplicating max-pool
   backward, the metrics (`utils/metric.py`), `NetTrainer.update /
   update_all / evaluate` with gradient accumulation and the
   divergence guard, optimizer state in checkpoints, and the CLI tasks
   train / finetune and `continue = 1`. Kernel: K1-bwd, the LRN input
   gradient (`csrc/lrn_bwd.cu`).
3. The sequence family: `ops/attention.py` (naive and blockwise
   attention, the online-softmax partials), the layers attention,
   attention_naive, seq_fullc, layernorm, pos_embed, split and add
   (`layers/attention.py`, `layers/common.py`), so that
   examples/LongSeq/seq_mnist.conf trains and serves. Kernels: K2-fwd,
   K2-dq and K2-dkv, the flash-attention forward and its two gradients
   (`csrc/attn_fwd.cu`, `attn_dq.cu`, `attn_dkv.cu`, wrapped by the
   autograd Function of `ops/flash_attention.py`) - on the card at
   every head_dim (past 256 on the kernels' wide route) and every
   length, where the JAX package takes its TPU kernel only for
   Mosaic-tileable shapes.
4. The graph passes and int8 serving (`nnet/passes.py`, K3
   `csrc/int8_mm.cu`).
5. The image data pipeline (`io/`: img, imgbin / imgbinx, the host
   augmenter, threadbuffer, membuffer, attachtxt, the retry wrapper;
   `utils/binary_page.py`, `tools/im2bin.py`,
   `tools/imgbin_partition.py`), the staged prefetch
   (`io/prefetch.py`: pinned buffers and a side stream on the card) and
   `device_augment` (`ops/augment.py`), so that the ImageNet-family and
   kaggle_bowl confs train through the CLI on their own data.
6. The remaining layer types: concat / ch_concat, gelu, xelu,
   insanity, prelu, insanity_max_pooling, fixconn (`layers/common.py`),
   transformer_stack (`layers/transformer_stack.py`, its attention core
   K2), moe (`layers/moe.py`, with the network's auxiliary-loss
   protocol), conv_im2col and `pairtest-A-B` (`layers/pairtest.py`)
   and the `torch` module type (`layers/torch_module.py`), so that
   examples/ImageNet/GoogLeNet.conf and examples/LongSeq/stack_moe.conf
   train and serve.
7. The native image decoder (`io/native.py`, `use_native`): a threaded
   BinaryPage reader and a pool of nvJPEG decode workers
   (`csrc/nvjpeg_io.cu`) in the imgbin iterators on the card, with its
   plain version (`PlainBinReader`) on the CPU.
8. The trainer's last single-device keys: `steps_per_dispatch` (K
   staged batches as one fused chunk: `StagedChunk`, `stage_chunk`,
   `update_chunk`, chunked prefetch, with the divergence guard's
   counters on the device and one finite-flag readback a chunk),
   `remat` (checkpoint segments, `Network.remat_segments`), `profile`
   / `profile_dir` / `trace_round` (`utils/profiler.py` on
   torch.profiler) and `tuning_cache` (`nnet/tuning.py`), with the
   tools `fused_smoke`, `profile_step` and `autotune`.

Ground rules:

- The JAX package is the reference the port is held against; it is
  never edited. Tests run both on the same numpy inputs and weights.
- This package imports `torch` and never `jax`, and nothing of
  `cxxnet_tpu` - not even its jax-free modules. It keeps its own copies
  of what it needs (`utils/config.py`, `nnet/net_config.py`,
  `nnet/checkpoint.py`, `ops/attention.py`, ...).
- Module names, layouts and param keys follow the JAX package: NCHW
  activations, OIHW conv weights, (nhidden, nin) fullc weights, params
  as {param_key: {"wmat", "bias"}} and the sequence layers' own names
  (`wproj` of attention, `slope` of layernorm) - so weights cross
  unchanged (`convert.py`).
- Every TPU (Pallas) kernel on the path is a kernel written by hand for
  Hopper (`csrc/`, built with nvcc at first use - `kernels.py`); its
  wrapper launches it for a CUDA tensor or raises, and uses the plain
  PyTorch version only for a tensor on the CPU. Work the JAX package
  hands to XLA (convolutions, matmuls, pooling) goes to
  `torch.nn.functional`.
- Entry points (`NetTrainer`, `Server`, the CLI) run on the card
  (`cuda:0`, or `cuda:<local rank>` in a multi-worker job) unless the
  caller asks for the CPU (`device="cpu"`, or `dev = cpu` in a conf);
  with no card they raise instead of carrying on on the CPU.
- Parallelism (`parallel/`): a mesh of N devices is N processes, one
  device each, in one torch.distributed process group (param_server =
  dist under tools/launch_dist, `mesh`, a device list): the data axis
  with ZeRO 1-3, sharded iterators, test_on_server, sync-BN and
  fullc_gather; the model, seq, expert and pipe axes; elastic training
  (`parallel/coordinator.py`, `parallel/elastic.py`: round barriers,
  the leader's one checkpoint, respawn or reshape of a pod that loses a
  member). `task = serve` serves in one process whose mesh only sizes
  the buckets. Every key of the JAX package is ported.
- PyTorch idiom inside: plain functions on tensors and modules with an
  explicit device, an explicit `torch.Generator` for every random draw,
  `torch.autograd.Function` where a kernel needs a gradient (the
  attention core's saves (q, k, v, o, lse) and its backward launches
  K2-dq and K2-dkv). Params stay float32 master tensors in the JAX
  package's pytree form, and the updater state mirrors its
  `state["ustate"]`, so checkpoints and `convert.py` carry both across
  unchanged.
"""
