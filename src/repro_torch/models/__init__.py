"""Models of the port: the paper's FCNN, and the LMs behind
``api.get_model``: the dense transformer (``transformer``), the MoE
transformer (``moe``) and the Zamba2 hybrid (``mamba2``, ``zamba2``),
over ``layers`` and ``tree``."""
