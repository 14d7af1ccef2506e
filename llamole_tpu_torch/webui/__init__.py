"""The web UI of the port (counterpart of llamole_tpu/webui and the
repo's launch.py): workflow.py (model state, process_input, generate),
server.py (the stdlib HTTP page and JSON API) and `python -m
llamole_tpu_torch.webui` (gradio when installed, else the stdlib
server)."""

from .workflow import generate, load_model_and_tokenizer, process_input
