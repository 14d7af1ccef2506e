"""Training for llamole_tpu_torch (counterpart of llamole_tpu/train): the
optimizer, the training loop and run_mmsft; the graph-module pretrainings
(pretrain.py) and the learned-weights stack (stack.py)."""
