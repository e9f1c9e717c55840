"""Minimal OpenAI-compatible HTTP client (Chat Completions + Responses).

Counterpart of ``semtools_tpu/ask/openai_client.py``, over the standard
library (:mod:`semtools_tpu_torch.utils.http`) instead of ``httpx``; the
transport is injectable. The two endpoints the agent needs are called
directly, with the same payloads; a ``base_url`` override points at any
OpenAI-compatible server, which is also how the tests inject a fake LLM.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from semtools_tpu_torch.utils import http
from semtools_tpu_torch.utils.tracing import stage

DEFAULT_BASE_URL = "https://api.openai.com/v1"


class OpenAIClient:
    def __init__(
        self,
        api_key: str,
        base_url: Optional[str] = None,
        transport: Optional[http.Client] = None,
    ):
        self.base_url = (base_url or DEFAULT_BASE_URL).rstrip("/")
        self._http = transport or http.Client(timeout=300.0)
        self._headers = {
            "Authorization": f"Bearer {api_key}",
            "Content-Type": "application/json",
        }

    def _post(self, path: str, payload: Dict) -> Dict:
        with stage("llm"):
            resp = self._http.post(
                f"{self.base_url}{path}", headers=self._headers,
                body=http.encode_json(payload),
            )
        if resp.is_error:
            raise RuntimeError(f"LLM API error {resp.status_code}: {resp.text}")
        return resp.json()

    # -- Chat Completions API ---------------------------------------------

    def chat_completion(
        self,
        model: str,
        messages: List[Dict],
        tools: Optional[List[Dict]] = None,
    ) -> Dict:
        """Returns the first choice's message dict."""
        payload: Dict = {"model": model, "messages": messages}
        if tools:
            payload["tools"] = tools
        data = self._post("/chat/completions", payload)
        choices = data.get("choices") or []
        if not choices:
            raise RuntimeError("No choices in response")
        return choices[0]["message"]

    # -- Responses API -----------------------------------------------------

    def responses_create(
        self,
        model: str,
        input_items: List[Dict],
        instructions: str,
        tools: Optional[List[Dict]] = None,
        max_output_tokens: int = 4096,
    ) -> Dict:
        """Returns the raw response body (caller walks ``output``)."""
        payload: Dict = {
            "model": model,
            "input": input_items,
            "instructions": instructions,
            "max_output_tokens": max_output_tokens,
            "store": False,
        }
        if tools:
            payload["tools"] = tools
        return self._post("/responses", payload)


def response_output_text(response: Dict) -> Optional[str]:
    """Concatenate output_text parts of a Responses API result."""
    parts: List[str] = []
    for item in response.get("output", []):
        if item.get("type") == "message":
            for piece in item.get("content", []):
                if piece.get("type") == "output_text":
                    parts.append(piece.get("text", ""))
    return "".join(parts) if parts else None
