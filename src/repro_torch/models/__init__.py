"""The LM stack in PyTorch: one generic decoder for the ten assigned
architectures (``repro_torch.configs``), the reference's ``repro.models``.

``config`` (shapes and layer plans), ``params`` (parameter specs, random
init, the reference's weights carried across, the ``Decoder`` module),
``common`` (norms, activations, RoPE), the sequence mixers ``attention``,
``rwkv`` and ``mamba``, ``ffn`` (dense and MoE) and ``transformer`` (layer
dispatch, layer groups, caches, forward). The layer functions are plain
functions on tensors and run on the device of their inputs; the serving
steps over them are ``repro_torch.serving.engine``.
"""
