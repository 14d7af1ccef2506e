"""Two-phase MolQA evaluation with the port (counterpart of
llamole_tpu/eval): workflow.run_molqa, the MolQA dataset, and the
generation-quality scores (scoring.py, text metrics in metric.py).

Kept out of this file on purpose: `llamole_tpu/eval/__init__.py` imports
its workflow, which imports JAX, so the port never imports
`llamole_tpu.eval.*`; each module here imports only torch, numpy and the
JAX-free host layers.
"""
