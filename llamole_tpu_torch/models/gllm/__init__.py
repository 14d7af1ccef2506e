from .config import LLMConfig
from .lora import lora_scale
from .model import LLM
