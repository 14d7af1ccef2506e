"""Two-phase MolQA evaluation with the port (counterpart of
llamole_tpu/eval): workflow.run_molqa, the MolQA dataset, and the
generation-quality scores (scoring.py, text metrics in metric.py).

Each module here imports only torch, numpy and the port's own host
layers (chem/, data/, utils/).
"""
