"""DNS-MOS scoring client (reference tools/dns_mos.py:26-117).

    python -m fullsubnet_plus_torch.cli.dns_mos -I wav_dir -O scores.csv \
        --auth-key KEY [--p835]

Counterpart of fullsubnet_plus_tpu/cli/dns_mos.py with the same flags and
behaviour: POSTs each wav under the input directory to the hosted DNSMOS
P.808 (or, with --p835, P.835) service with an authorization key, retries
a failed request with a backoff of 1, 2, 4 s, and appends each score to the
CSV as it comes. A CSV that already exists is resumed: its files are
skipped. A file whose requests all fail is reported and skipped. It needs
network access to the service; nothing else in the package does.
"""

from __future__ import annotations

import argparse
import base64
import csv
import json
import os
import time
from urllib.request import Request, urlopen

from fullsubnet_plus_torch.data.wav import read_wav

P808_URL = "https://dnsmos.azurewebsites.net/score"
P835_URL = "https://dnsmos.azurewebsites.net/v1/dnsmosp835/score"


def score_file(path: str, auth_key: str, p835: bool = False, retries: int = 3) -> dict:
    """The service's JSON reply for one wav; RuntimeError after `retries`
    failed attempts."""
    with open(path, "rb") as f:
        audio_bytes = f.read()
    payload = json.dumps({"data": base64.b64encode(audio_bytes).decode("ascii"),
                          "filename": os.path.basename(path)}).encode()
    url = P835_URL if p835 else P808_URL
    last_error = None
    for attempt in range(retries):
        try:
            req = Request(url, data=payload, headers={"Content-Type": "application/json",
                                                      "Authorization": f"Basic {auth_key}"})
            with urlopen(req, timeout=50) as resp:
                return json.loads(resp.read().decode())
        except Exception as e:  # a network or HTTP failure: back off and retry
            last_error = e
            time.sleep(2 ** attempt)
    raise RuntimeError(f"DNS-MOS scoring failed for {path}: {last_error}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="DNS-MOS API client")
    parser.add_argument("-I", "--input_dir", required=True)
    parser.add_argument("-O", "--output_csv", required=True)
    parser.add_argument("--auth-key", required=True)
    parser.add_argument("--p835", action="store_true")
    args = parser.parse_args(argv)

    done = set()
    if os.path.exists(args.output_csv):  # resume
        with open(args.output_csv) as f:
            done = {row["filename"] for row in csv.DictReader(f)}
    wavs = sorted(os.path.join(root, fn) for root, _, files in os.walk(args.input_dir)
                  for fn in files if fn.endswith(".wav"))

    mode = "a" if done else "w"
    with open(args.output_csv, mode, newline="") as f:
        writer = None
        for path in wavs:
            name = os.path.basename(path)
            if name in done:
                continue
            read_wav(path)  # decodable before the upload
            try:
                result = score_file(path, args.auth_key, p835=args.p835)
            except RuntimeError as e:
                print(e)
                continue
            row = {"filename": name,
                   **{k: v for k, v in result.items() if not isinstance(v, (list, dict))}}
            if writer is None:
                writer = csv.DictWriter(f, fieldnames=list(row))
                if mode == "w":
                    writer.writeheader()
            writer.writerow(row)
            f.flush()
            print(name, row.get("mos", row))


if __name__ == "__main__":
    main()
