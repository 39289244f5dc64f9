"""LLM client abstraction for the agent layer.

The reference hard-wires LangChain's ``ChatOpenAI``
(multi_agent_orchestrator.py:57).  Here the agent layer talks to a minimal
``ChatLLM`` protocol so it can run against:

* :class:`OpenAIChatLLM` — any OpenAI-compatible chat endpoint (api key +
  base url from env), via plain ``requests``;
* :class:`FakeLLM` — canned responses for hermetic tests (SURVEY.md §4:
  "end-to-end NL-query tests with a fake LLM");
* ``None`` — the parser falls back to its deterministic rule-based extractor,
  so the whole stack works with zero network access.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


class ChatLLM:
    """Protocol: invoke(messages) -> assistant text.

    messages: list of {"role": "system"|"user"|"assistant", "content": str}.
    """

    def invoke(self, messages: Sequence[Dict[str, str]]) -> str:  # pragma: no cover
        raise NotImplementedError


class OpenAIChatLLM(ChatLLM):
    """OpenAI-compatible chat completion client (no SDK dependency)."""

    def __init__(self, model: str = "gpt-4o", temperature: float = 0.0,
                 api_key: Optional[str] = None, base_url: Optional[str] = None,
                 timeout: float = 120.0):
        self.model = model
        self.temperature = temperature
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = (base_url or os.environ.get("OPENAI_BASE_URL")
                         or "https://api.openai.com/v1").rstrip("/")
        self.timeout = timeout
        if not self.api_key:
            raise RuntimeError(
                "OPENAI_API_KEY not found. Please set it in your environment "
                "or create a .env file with OPENAI_API_KEY=your_key"
            )

    def invoke(self, messages: Sequence[Dict[str, str]]) -> str:
        import requests

        resp = requests.post(
            f"{self.base_url}/chat/completions",
            headers={"Authorization": f"Bearer {self.api_key}",
                     "Content-Type": "application/json"},
            json={"model": self.model, "temperature": self.temperature,
                  "messages": list(messages)},
            timeout=self.timeout,
        )
        resp.raise_for_status()
        return resp.json()["choices"][0]["message"]["content"]


class FakeLLM(ChatLLM):
    """Deterministic stub: returns canned responses in order (or a constant)."""

    def __init__(self, responses: Optional[List[str]] = None, default: str = "{}"):
        self.responses = list(responses or [])
        self.default = default
        self.calls: List[List[Dict[str, str]]] = []

    def invoke(self, messages: Sequence[Dict[str, str]]) -> str:
        self.calls.append(list(messages))
        if self.responses:
            return self.responses.pop(0)
        return self.default


def default_llm() -> Optional[ChatLLM]:
    """An OpenAI client when a key is configured, else None (rule-based mode)."""
    if os.environ.get("OPENAI_API_KEY"):
        try:
            return OpenAIChatLLM(model=os.environ.get("PDE_TPU_LLM_MODEL", "gpt-4o"))
        except RuntimeError:
            return None
    return None


def extract_json_block(text: str) -> Optional[dict]:
    """Robustly pull a JSON object out of an LLM reply (handles ``` fences
    and surrounding prose) — the repair cascade the reference implements at
    pde_parser_agent.py:798-921, condensed."""
    if not text:
        return None
    t = text.strip()
    if "```json" in t:
        t = t.split("```json", 1)[1].split("```", 1)[0].strip()
    elif "```" in t:
        t = t.split("```", 1)[1].split("```", 1)[0].strip()
    for candidate in (t,):
        try:
            out = json.loads(candidate)
            if isinstance(out, dict):
                return out
        except json.JSONDecodeError:
            pass
    start, end = t.find("{"), t.rfind("}")
    if 0 <= start < end:
        try:
            out = json.loads(t[start:end + 1])
            if isinstance(out, dict):
                return out
        except json.JSONDecodeError:
            return None
    return None
