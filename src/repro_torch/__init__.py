"""PyTorch/CUDA port of the SMaRTT packet simulator, of the model zoo's
serving and training paths and of the collective bridge between them.

Mirrors the layout of the JAX package (``netsim/``, ``core/``,
``models/``, ``configs/``, ``serve/``, ``collectives/``, ``train/``,
``optim/``, ``data/``, ``checkpoint/``,
``kernels/<name>/{ref,kernel,ops}.py``)
so every counterpart is easy to find.  The kernels are hand-written CUDA
C++ for Hopper (``csrc/*.cu``), built at first use into
``build/repro_torch/`` at the repository root and bound with ``ctypes``.

Entry points run on the card unless the caller asks for the CPU::

    from repro_torch.netsim import scenarios
    sim = scenarios.scenario("perm_1024n_3t").build()            # cuda
    sim = scenarios.scenario("tiny_perm4").build(device="cpu")   # plain
    st = sim.run(20_000)

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import generate
    model = LM(get_config("qwen3-0.6b"), generator=g)            # cuda
    tokens = generate(model, prompt, max_new=32, max_len=545)

    from repro_torch.train.loop import LoopConfig, train
    model, opt, losses = train(cfg, tcfg, LoopConfig(steps=8), dcfg)   # cuda
"""
