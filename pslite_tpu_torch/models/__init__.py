"""Models and workload generators driven through the port's PS.

Counterpart of ``pslite_tpu/models``: PSFormer, the flagship transformer
LM (``transformer.py``), trained through the flat-store PS cycle
(``ps_step.py``, ``train.py``: pull, grad, K4's ring push with the SGD
update); the CNN (``cnn.py``) and DLRM (``dlrm.py``, dense and sparse
planes: K4, S1/S2, S3); and the reference benchmark's traffic models
(``resnet_trace.py``, ``embedding.py``).
"""

from .transformer import ModelConfig, forward, init_params, loss_fn

__all__ = ["ModelConfig", "forward", "init_params", "loss_fn"]
