"""Chat-template registry: named templates mapping a message list to a
prompt string with the generation prompt. The port's own copy of
socioreasoner_tpu/datasets/chat_template.py.

Registered names: native / qwen2_5 / chatml / qwen2-vl (the model's own chat
format, chatml for Qwen), base and empty (one user turn in a raw format
string), longCOT_qwen2.5 (boxed-answer long-CoT with its default system
prompt) and longcot_V3 (a <think> primer). Each template injects a default
system message when the conversation lacks one."""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List

TEMPLATES: Dict[str, Callable] = {}

# ref roll/utils/prompt.py:28 (LONGCOT_QWEN_2_5_SYSTEM) — abridged to the
# operative instruction; and :37-44 (BASE_CHAT_FORMAT)
LONGCOT_QWEN_2_5_SYSTEM = (
    "Your role as an assistant involves thoroughly exploring questions "
    "through a systematic long thinking process before providing the final "
    "precise and accurate solutions. Detail your reasoning between "
    "<|begin_of_thought|> and <|end_of_thought|>, then give the final "
    "solution between <|begin_of_solution|> and <|end_of_solution|>.")
BASE_CHAT_FORMAT = (
    "A conversation between User and Assistant. The user asks a question, "
    "and the Assistant solves it. The assistant first thinks about the "
    "reasoning process in the mind and then provides the user with the "
    "answer, ensuring that the final result in the answer is enclosed in "
    "\\boxed{{}}. The reasoning process and answer are enclosed within "
    "'<think>' '</think>' and '<answer>' '</answer>' tags, respectively, "
    "i.e., <think> reasoning process here </think> <answer> answer here "
    "</answer>. User: {{content}} Assistant:")
EMPTY_CHAT_FORMAT = "<|im_start|>user\n{{content}}<|im_end|>\n<|im_start|>assistant\n"


def register_template(*names: str, **defaults):
    def deco(fn):
        for name in names:
            if name in TEMPLATES:
                raise ValueError(f"chat template {name!r} already exists")
            TEMPLATES[name] = partial(fn, **defaults) if defaults else fn
        return fn
    return deco


def get_chat_template(name: str) -> Callable:
    if name not in TEMPLATES:
        raise KeyError(f"unknown chat template {name!r}; have {sorted(TEMPLATES)}")
    return TEMPLATES[name]


def _with_default_system(messages: List[Dict[str, str]],
                         system) -> List[Dict[str, str]]:
    """ref add_default_system (chat_template.py:14-17)."""
    if system is not None and (not messages or messages[0].get("role") != "system"):
        return [{"role": "system", "content": system}] + list(messages)
    return list(messages)


@register_template("native", "qwen2_5", "chatml", "qwen2-vl")
def chatml(messages: List[Dict[str, str]],
           system: str = "You are a helpful assistant.") -> str:
    parts = []
    for m in _with_default_system(messages, system):
        parts.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


@register_template("longCOT_qwen2.5", "longcot_qwen2.5")
def longcot_qwen2_5(messages: List[Dict[str, str]], **kw) -> str:
    """ref chat_template.py:66-76: default long-CoT system prompt + boxed
    final-answer instruction prefixed to every user turn."""
    msgs = [dict(m) for m in messages]
    for m in msgs:
        if m.get("role") == "user":
            m["content"] = ("Return your final response within \\boxed{}. "
                            + m["content"])
    return chatml(msgs, system=kw.get("system", LONGCOT_QWEN_2_5_SYSTEM))


@register_template("longcot", "longcot_V3")
def longcot(messages: List[Dict[str, str]], **kw) -> str:
    """ref chat_template.py:79-84: native template + <think> primer."""
    return chatml(messages, **kw) + "<think>\n"


@register_template("base", base_format=BASE_CHAT_FORMAT)
@register_template("empty", base_format=EMPTY_CHAT_FORMAT)
def base(messages: List[Dict[str, str]], base_format: str = BASE_CHAT_FORMAT,
         **kw) -> str:
    """ref chat_template.py:58-62: single user turn into a raw format string."""
    user = [m for m in messages if m.get("role") == "user"]
    assert len(user) == 1, "base/empty templates take exactly one user turn"
    return base_format.replace("{{content}}", user[0]["content"])
