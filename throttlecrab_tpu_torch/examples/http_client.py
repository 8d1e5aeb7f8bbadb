"""Call a running throttlecrab server over HTTP/JSON — the client-side
example every protocol has (reference:
throttlecrab-server/examples/http_client.rs:1-92).

The port's counterpart of the JAX package's `examples/http_client.py`.
Start a server first:
    python -m throttlecrab_tpu_torch.server --http --http-port 9090

Then:
    python -m throttlecrab_tpu_torch.examples.http_client
        [--url http://127.0.0.1:9090]

Uses only the standard library, so it doubles as the copy-paste snippet
for services without an HTTP client dependency.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request


def throttle(
    base_url: str,
    key: str,
    max_burst: int,
    count_per_period: int,
    period: int,
    quantity: int = 1,
) -> dict:
    """One rate-limit decision.  Returns the response dict:
    {"allowed", "limit", "remaining", "reset_after", "retry_after"}."""
    req = urllib.request.Request(
        f"{base_url}/throttle",
        data=json.dumps(
            {
                "key": key,
                "max_burst": max_burst,
                "count_per_period": count_per_period,
                "period": period,
                "quantity": quantity,
            }
        ).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://127.0.0.1:9090")
    args = ap.parse_args(argv)

    print("Basic rate limiting (burst 10):")
    for i in range(12):
        r = throttle(args.url, "user:456", 10, 20, 60)
        verdict = "allowed" if r["allowed"] else (
            f"DENIED (retry after {r['retry_after']}s)"
        )
        print(f"  request {i + 1:2d}: {verdict}  remaining={r['remaining']}")

    print("\nPer-key isolation:")
    for key in ("user:1", "user:2", "user:1"):
        r = throttle(args.url, key, 3, 10, 60)
        print(f"  {key}: allowed={r['allowed']} remaining={r['remaining']}")

    print("\nCost > 1 (quantity=5 against burst 10):")
    for i in range(3):
        r = throttle(args.url, "bulk:job", 10, 100, 60, quantity=5)
        print(f"  request {i + 1}: allowed={r['allowed']} "
              f"remaining={r['remaining']}")

    print("\nServer health + metrics:")
    with urllib.request.urlopen(f"{args.url}/health", timeout=5) as resp:
        print(f"  /health -> {resp.read().decode()}")
    with urllib.request.urlopen(f"{args.url}/metrics", timeout=5) as resp:
        lines = resp.read().decode().splitlines()
        wanted = [ln for ln in lines if ln.startswith("throttlecrab_requests")]
        for ln in wanted[:4]:
            print(f"  {ln}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
