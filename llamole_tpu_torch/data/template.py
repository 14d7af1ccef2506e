"""Chat templates for the three supported model families.

The reference registers 45+ templates (data/template.py) but its configs
only exercise llama3 (template.py:675), mistral (:700) and qwen (:755).
Each template renders (system, user, assistant) turns to strings; token
ids come from the tokenizer, so control markers must be registered as
special tokens on byte-level tokenizers.

encode_multiturn yields (source_ids, target_ids) per exchange —
the contract encode_supervised_example consumes (template.py:76-110).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class Template:
    name: str
    user_fmt: str                      # receives {content} (+ {system} on 1st turn)
    assistant_fmt: str                 # receives {content}
    system_fmt: str = ""               # rendered into first user turn
    prefix: str = ""                   # once, at sequence start
    default_system: str = ""
    stop_words: List[str] = field(default_factory=list)
    control_tokens: List[str] = field(default_factory=list)
    efficient_eos: bool = False
    # gemma has no system role: fold the system text INSIDE the first
    # user turn's content instead of rendering it before the turn marker
    system_in_user: bool = False

    def render_prompt(self, messages: Sequence[Dict[str, str]],
                      system: Optional[str] = None) -> str:
        """Full prompt text ending with the assistant generation header
        (HF apply_chat_template(add_generation_prompt=True) analog)."""
        parts = [self.prefix]
        system = system if system is not None else self.default_system
        sys_txt = self.system_fmt.format(content=system) if system else ""
        first = True
        for m in messages:
            if m["role"] == "user":
                if self.system_in_user:
                    content = ((sys_txt if first else "") + m["content"])
                    parts.append(self.user_fmt.format(content=content))
                else:
                    parts.append((sys_txt if first else "")
                                 + self.user_fmt.format(content=m["content"]))
                first = False
            elif m["role"] == "assistant":
                parts.append(self.assistant_fmt.format(content=m["content"]))
            elif m["role"] == "system":
                sys_txt = self.system_fmt.format(content=m["content"])
        return "".join(parts)

    def encode_multiturn(
        self, tokenizer, messages: Sequence[Dict[str, str]],
        system: Optional[str] = None,
    ) -> List[Tuple[List[int], List[int]]]:
        """[(source_ids, target_ids)] per user/assistant exchange."""
        system = system if system is not None else self.default_system
        sys_txt = self.system_fmt.format(content=system) if system else ""
        pairs = []
        pending_source = None
        turn = 0
        for m in messages:
            if m["role"] == "user":
                if self.system_in_user and turn == 0:
                    text = self.prefix + self.user_fmt.format(
                        content=sys_txt + m["content"])
                else:
                    text = self.user_fmt.format(content=m["content"])
                    if turn == 0:
                        text = self.prefix + sys_txt + text
                pending_source = tokenizer.encode(text, add_special_tokens=False)
                turn += 1
            elif m["role"] == "assistant":
                target = tokenizer.encode(
                    self.assistant_fmt.format(content=m["content"]),
                    add_special_tokens=False)
                pairs.append((pending_source or [], target))
                pending_source = None
        if pending_source is not None:
            pairs.append((pending_source, []))
        return pairs


TEMPLATES: Dict[str, Template] = {}


def _register(t: Template) -> None:
    TEMPLATES[t.name] = t


_register(Template(
    name="llama3",
    prefix="<|begin_of_text|>",
    system_fmt="<|start_header_id|>system<|end_header_id|>\n\n{content}<|eot_id|>",
    user_fmt=("<|start_header_id|>user<|end_header_id|>\n\n{content}<|eot_id|>"
              "<|start_header_id|>assistant<|end_header_id|>\n\n"),
    assistant_fmt="{content}<|eot_id|>",
    stop_words=["<|eot_id|>"],
    control_tokens=["<|begin_of_text|>", "<|start_header_id|>",
                    "<|end_header_id|>", "<|eot_id|>"],
))

_register(Template(
    name="qwen",
    system_fmt="<|im_start|>system\n{content}<|im_end|>\n",
    user_fmt="<|im_start|>user\n{content}<|im_end|>\n<|im_start|>assistant\n",
    assistant_fmt="{content}<|im_end|>\n",
    default_system="You are a helpful assistant.",
    stop_words=["<|im_end|>"],
    control_tokens=["<|im_start|>", "<|im_end|>"],
))

_register(Template(
    name="mistral",
    prefix="<s>",
    system_fmt="{content}\n\n",
    user_fmt="[INST] {content} [/INST]",
    assistant_fmt="{content}</s>",
    control_tokens=["<s>", "</s>", "[INST]", "[/INST]"],
))

# gemma has no system role: the system text folds INSIDE the first user
# turn's content (HF gemma chat template behavior — instruction-tuned
# gemma never saw bare text between <bos> and the first turn marker)
_register(Template(
    name="gemma",
    prefix="<bos>",
    system_fmt="{content}\n\n",
    system_in_user=True,
    user_fmt=("<start_of_turn>user\n{content}<end_of_turn>\n"
              "<start_of_turn>model\n"),
    assistant_fmt="{content}<end_of_turn>\n",
    stop_words=["<end_of_turn>"],
    control_tokens=["<bos>", "<start_of_turn>", "<end_of_turn>"],
))

# minimal template for byte-tokenizer smoke tests
_register(Template(
    name="default",
    system_fmt="System: {content}\n",
    user_fmt="User: {content}\nAssistant: ",
    assistant_fmt="{content}\n",
    efficient_eos=True,
))


def get_template(name: Optional[str], tokenizer=None) -> Template:
    """Fetch a template; registers its control tokens on byte-level
    tokenizers so markers encode to single ids
    (parity: get_template_and_fix_tokenizer, template.py:341-387)."""
    t = TEMPLATES.get(name or "default")
    if t is None:
        raise ValueError(f"unknown template {name!r}; "
                         f"known: {sorted(TEMPLATES)}")
    if tokenizer is not None and hasattr(tokenizer, "add_special_token"):
        for tok in t.control_tokens:
            tokenizer.add_special_token(tok)
    return t
