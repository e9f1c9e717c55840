"""LlamaParse HTTP client: upload, poll, retry with exponential backoff.

Counterpart of ``semtools_tpu/parse/client.py``, over the standard library
(:mod:`semtools_tpu_torch.utils.http`) instead of ``httpx``; the transport is
injectable as the JAX client's ``httpx.Client`` is. The protocol and the
retry rules are the JAX client's:

- ``POST {base}/api/v2/parse/upload`` multipart with the file and a
  ``configuration`` JSON field (tier/version defaults injected when absent);
  ``fast`` tier expands ``text``, others ``markdown``;
- ``GET {base}/api/v2/parse/{job_id}`` polled every ``check_interval``
  seconds until COMPLETED/FAILED/CANCELLED, with a hard ``max_timeout``;
- on COMPLETED, re-GET with ``?expand=markdown|text`` and assemble pages,
  logging-and-skipping per-page failures;
- retryable: connect errors, timeouts, transport errors and HTTP >= 500, up
  to ``max_retries`` times with ``retry_delay_ms * backoff_multiplier**attempt``
  backoff; terminal: other 4xx, :class:`InvalidResponse`, :class:`JobTimeout`.
"""

from __future__ import annotations

import json
import mimetypes
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from semtools_tpu_torch.parse.config import (
    DEFAULT_PARSE_TIER,
    DEFAULT_PARSE_VERSION,
    LlamaParseConfig,
)
from semtools_tpu_torch.utils import http


class JobError(Exception):
    pass


class JobTimeout(JobError):
    def __str__(self) -> str:
        return "Operation timed out"


class RetryExhausted(JobError):
    pass


class InvalidResponse(JobError):
    pass


@dataclass
class CreatedJob:
    job_id: str
    expand_key: str


def _is_retryable(exc: Exception) -> bool:
    if isinstance(exc, http.TransportError):
        return True
    if isinstance(exc, http.HTTPStatusError):
        return exc.response.status_code >= 500
    return False


def _assemble_markdown(result: dict) -> str:
    """Join per-page content; failed pages are reported and skipped."""
    md = result.get("markdown")
    if md and "pages" in md:
        parts = []
        for page in md["pages"]:
            if "markdown" in page:
                parts.append(page["markdown"] + "\n\n")
            else:
                print(
                    f"An error occurred while parsing page "
                    f"{page.get('page_number')}: {page.get('error', 'unknown')}",
                    file=sys.stderr,
                )
        return "".join(parts)
    txt = result.get("text")
    if txt and "pages" in txt:
        return "".join(p.get("text", "") + "\n\n" for p in txt["pages"])
    raise InvalidResponse("Could not produce a parsing result for the current document")


class ParseClient:
    def __init__(self, transport: Optional[http.Client] = None):
        self._http = transport or http.Client(timeout=120.0)

    # -- retry wrappers ----------------------------------------------------

    def _with_retry(self, what: str, config: LlamaParseConfig, fn):
        last_error: Optional[Exception] = None
        for attempt in range(config.max_retries + 1):
            try:
                return fn()
            except JobTimeout:
                raise  # the job itself timed out; not a transport failure
            except (http.HTTPError, InvalidResponse) as exc:
                if isinstance(exc, InvalidResponse) or not _is_retryable(exc):
                    raise
                last_error = exc
                if attempt == config.max_retries:
                    raise RetryExhausted(
                        f"{what} failed after {config.max_retries + 1} attempts. "
                        f"Last error: {exc}"
                    )
                delay_ms = config.retry_delay_ms * (config.backoff_multiplier ** attempt)
                print(
                    f"{what} failed (attempt {attempt + 1}/{config.max_retries + 1}): "
                    f"{exc}. Retrying in {int(delay_ms)}ms...",
                    file=sys.stderr,
                )
                time.sleep(delay_ms / 1000.0)
        raise RetryExhausted(f"Unexpected retry exhaustion. Last error: {last_error}")

    # -- job lifecycle -----------------------------------------------------

    def create_parse_job(
        self, file_path: str, base_url: str, api_key: str, config: LlamaParseConfig
    ) -> CreatedJob:
        configuration = dict(config.parse_kwargs)
        configuration.setdefault("tier", DEFAULT_PARSE_TIER)
        configuration.setdefault("version", DEFAULT_PARSE_VERSION)
        expand_key = "text" if configuration.get("tier") == "fast" else "markdown"

        def attempt() -> CreatedJob:
            filename = Path(file_path).name
            mime = mimetypes.guess_type(file_path)[0] or "application/octet-stream"
            with open(file_path, "rb") as fh:
                content = fh.read()
            body, content_type = http.encode_multipart(
                {"configuration": json.dumps(configuration)},
                [("file", filename, content, mime)],
            )
            resp = self._http.post(
                f"{base_url}/api/v2/parse/upload",
                headers={"Authorization": f"Bearer {api_key}",
                         "Content-Type": content_type},
                body=body,
            )
            if resp.status_code >= 500:
                raise http.HTTPStatusError("server error", resp)
            if resp.is_error:
                raise InvalidResponse(f"Upload failed: {resp.text}")
            return CreatedJob(job_id=resp.json()["id"], expand_key=expand_key)

        return self._with_retry("Job creation", config, attempt)

    def poll_for_result(
        self, job: CreatedJob, base_url: str, api_key: str, config: LlamaParseConfig
    ) -> str:
        headers = {"Authorization": f"Bearer {api_key}"}

        def attempt() -> str:
            start = time.monotonic()
            while True:
                time.sleep(config.check_interval)
                if time.monotonic() - start > config.max_timeout:
                    raise JobTimeout()

                status_resp = self._http.get(
                    f"{base_url}/api/v2/parse/{job.job_id}", headers=headers
                )
                if status_resp.status_code >= 500:
                    raise http.HTTPStatusError("server error", status_resp)
                if status_resp.is_error:
                    print(
                        f"An error occurred: {status_resp.text}\nRetrying...",
                        file=sys.stderr,
                    )
                    continue
                status = status_resp.json().get("job", {}).get("status", "")

                if status == "COMPLETED":
                    result_resp = self._http.get(
                        f"{base_url}/api/v2/parse/{job.job_id}",
                        headers=headers,
                        params={"expand": job.expand_key},
                    )
                    if result_resp.is_error:
                        raise InvalidResponse("Failed to get result")
                    return _assemble_markdown(result_resp.json())
                if status in ("PENDING", "RUNNING"):
                    continue
                if status in ("FAILED", "CANCELLED"):
                    raise InvalidResponse(f"Job failed with status: {status}")
                raise InvalidResponse(f"Unknown status: {status}")

        return self._with_retry("Polling", config, attempt)

    def parse_file(
        self, file_path: str, base_url: str, api_key: str, config: LlamaParseConfig
    ) -> str:
        """Upload + poll one document, returning assembled markdown."""
        job = self.create_parse_job(file_path, base_url, api_key, config)
        return self.poll_for_result(job, base_url, api_key, config)
