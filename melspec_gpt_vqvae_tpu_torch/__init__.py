"""melspec_gpt_vqvae_tpu_torch -- the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside the JAX reference ``melspec_gpt_vqvae_tpu``, laid
out like it so each module's counterpart has the same name:

  - ``ops/``     plain PyTorch functions and the wrappers of the hand-written
                 Hopper kernels in ``csrc/``: the six of the JAX package's
                 Pallas kernels (whole-sequence attention, MelGAN resblock
                 stack, VQ nearest index, mel frontend, decode attention
                 over the quantised cache, training attention forward and
                 backward) and the int8 product's prologue and epilogue,
                 which XLA fuses there;
  - ``models/``  GPT (functional, KV-cached decode; on the card the decode
                 loop's body is a captured CUDA graph,
                 ``models/decode_graph.py``), VQ-VAE and MelGAN
                 ``nn.Module``s, the int8 decode stage's mirrors
                 (``models/quantized.py``, ``ops/quant.py``);
  - ``pipeline.py``, ``serving.py``  the generation round trip;
  - ``export.py``  the ``torch.export`` serving artifact;
  - ``training/``, ``train_gpt.py``  GPT-class training and its CLI;
  - ``configs.py``, ``data/``, ``utils/battery.py``  the port's own copies
                 of the JAX package's framework-free modules;
  - ``bridge.py``  JAX parameter trees -> the port, and random inits;
  - ``_build.py``  nvcc build of ``csrc/*.cu``, the ctypes binding and the
                 kernel switch's scope (``_build.kernels``).

Every kernel wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel (or raises) for CUDA tensors, unless the enclosing
``_build.kernels`` scope turns the kernels off, and counts its launches
in a ``launches`` attribute.  The package imports torch, never JAX and
nothing of the JAX package: what it needs of that package's framework-free
modules it keeps as its own copy, and ``bridge.config_from_jax`` turns a
config of one package into the other's class.  Entry points run on the card
unless the caller asks for the CPU.
"""
