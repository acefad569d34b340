"""Console and file logger (reference utils/logger.py:13-52).

Counterpart of fullsubnet_plus_tpu/utils/logger.py: timestamped lines to
the console and an optional log file, and an optional Slack webhook posted
from a daemon thread (a no-op without a URL). `print` is not patched; call
`log`. The module's functions drive one process-wide `Logger`.
"""

from __future__ import annotations

import json
import os
import threading
from datetime import datetime
from urllib.request import Request, urlopen


class Logger:
    def __init__(self):
        self._file = None
        self._run_name = None
        self._slack_url = None
        self._lock = threading.Lock()

    def init(self, filename: str | None, run_name: str | None = None,
             slack_url: str | None = None) -> None:
        """(Re)configure; `filename=None` closes any open log file."""
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            if filename:
                os.makedirs(os.path.dirname(os.path.abspath(filename)) or ".", exist_ok=True)
                self._file = open(filename, "a")
            self._run_name = run_name
            self._slack_url = slack_url

    def log(self, *args) -> None:
        msg = " ".join(str(a) for a in args)
        line = f"[{datetime.now().strftime('%Y-%m-%d %H:%M:%S.%f')}] {msg}"
        with self._lock:
            print(line, flush=True)
            if self._file is not None:
                self._file.write(line + "\n")
                self._file.flush()
            url, run_name = self._slack_url, self._run_name
        if url:
            threading.Thread(target=_post_slack, args=(url, run_name, msg), daemon=True).start()


def _post_slack(url: str, run_name: str | None, msg: str) -> None:
    payload = json.dumps({"text": f"{run_name}: {msg}" if run_name else msg}).encode()
    try:
        urlopen(Request(url, data=payload, headers={"Content-Type": "application/json"}),
                timeout=5)
    except Exception:  # noqa: BLE001 - a failed notification must never stop training
        pass


_LOGGER = Logger()
init = _LOGGER.init
log = _LOGGER.log
