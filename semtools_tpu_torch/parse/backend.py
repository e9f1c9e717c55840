"""Parse backend: cache check + bounded-concurrency fan-out to LlamaParse.

Counterpart of ``semtools_tpu/parse/backend.py``.

Orchestration parity with the reference (src/parse/backend.rs): readable
text files pass through unparsed; cached results short-circuit; the rest
fan out to the cloud API with at most ``num_ongoing_requests`` in flight
(the reference's tokio Semaphore, backend.rs:32 — here a thread pool of the
same width, since each job is blocking HTTP + poll-sleep); per-file
failures are printed and dropped so one bad document never kills the batch
(backend.rs:94-99).
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence

from semtools_tpu_torch.parse.cache import CacheManager
from semtools_tpu_torch.parse.client import JobError, ParseClient
from semtools_tpu_torch.parse.config import DEFAULT_BASE_URL, LlamaParseConfig
from semtools_tpu_torch.utils.tracing import stage


@dataclass
class ParseResult:
    input_path: str
    output_path: str
    was_cached: bool


class LlamaParseBackend:
    def __init__(
        self,
        config: LlamaParseConfig,
        verbose: bool = False,
        cache_dir: Optional[str] = None,
        client: Optional[ParseClient] = None,
    ):
        self.config = config
        self.verbose = verbose
        self.cache_manager = CacheManager(cache_dir)
        self.client = client or ParseClient()

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, file=sys.stderr)

    def _parse_one(self, file_path: str) -> str:
        self._log(f"Processing file: {file_path}")
        base_url = self.config.base_url or DEFAULT_BASE_URL
        api_key = self.config.api_key or ""
        with stage("parse_job"):  # upload, polls and result, summed over the jobs
            content = self.client.parse_file(file_path, base_url, api_key, self.config)
        return self.cache_manager.write_results_to_disk(file_path, content)

    def parse_detailed(self, files: Sequence[str]) -> List[ParseResult]:
        """Parse files, returning (input, output, cache-hit) per success."""
        results: List[ParseResult] = []
        to_submit: List[str] = []

        for file_path in files:
            if self.cache_manager.should_skip_file(file_path):
                self._log(f"Skipping readable file: {file_path}")
                results.append(ParseResult(file_path, file_path, False))
                continue
            cached = self.cache_manager.get_cached_result(file_path)
            if cached is not None:
                self._log(f"Using cached result for: {file_path}")
                results.append(ParseResult(file_path, cached, True))
                continue
            to_submit.append(file_path)

        if to_submit:
            with ThreadPoolExecutor(max_workers=self.config.num_ongoing_requests) as pool:
                futures = {pool.submit(self._parse_one, f): f for f in to_submit}
                for fut, f in futures.items():
                    try:
                        results.append(ParseResult(f, fut.result(), False))
                    except (JobError, OSError) as e:
                        print(f"Error processing file: {e}", file=sys.stderr)

        return results

    def parse(self, files: Sequence[str]) -> List[str]:
        """Output paths, one per successfully handled input, in order."""
        return [r.output_path for r in self.parse_detailed(files)]
