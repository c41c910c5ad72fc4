#!/usr/bin/env python
"""Reproducible downloader for the BASELINE.md config ladder's SNAP
datasets (the reference's primary experiment inputs — its CLI consumes
exactly these edge-list files, /root/reference/main.cc:102,
/root/reference/mcmc/data.cc:36-78).

This build image has ZERO network egress (verified: DNS resolution
fails), so real-dataset runs are blocked HERE — but anywhere with
network this script fetches, checksums-by-size, and unpacks the ladder:

    python scripts/fetch_datasets.py --dest data/ [--rungs ca-HepPh ...]

then run each rung end-to-end:

    python scripts/run_ladder.py --data data/ --out ladder_out/
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import sys
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # repo root (package not pip-installed)

# (name, url, approx nodes, approx edges) — sizes are published SNAP
# stats used as sanity checks after parsing, not cryptographic pins.
LADDER = {
    "ca-HepPh": (
        "https://snap.stanford.edu/data/ca-HepPh.txt.gz",
        12_008, 118_521),
    "com-dblp": (
        "https://snap.stanford.edu/data/bigdata/communities/"
        "com-dblp.ungraph.txt.gz",
        317_080, 1_049_866),
    "com-youtube": (
        "https://snap.stanford.edu/data/bigdata/communities/"
        "com-youtube.ungraph.txt.gz",
        1_134_890, 2_987_624),
    "com-lj": (
        "https://snap.stanford.edu/data/bigdata/communities/"
        "com-lj.ungraph.txt.gz",
        3_997_962, 34_681_189),
    "com-friendster": (
        "https://snap.stanford.edu/data/bigdata/communities/"
        "com-friendster.ungraph.txt.gz",
        65_608_366, 1_806_067_135),
}


def fetch(name: str, dest: str) -> str:
    url, n_nodes, n_edges = LADDER[name]
    os.makedirs(dest, exist_ok=True)
    gz_path = os.path.join(dest, os.path.basename(url))
    txt_path = gz_path[:-3]
    if os.path.exists(txt_path):
        print(f"{name}: already present at {txt_path}")
        return txt_path
    print(f"{name}: fetching {url}")
    urllib.request.urlretrieve(url, gz_path)
    with gzip.open(gz_path, "rb") as src, open(txt_path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.unlink(gz_path)

    # sanity: parse with the repo loader and compare against SNAP stats
    from mcmc_ammsb.data import load_snap_edges
    n, u, v = load_snap_edges(txt_path)
    print(f"{name}: parsed N={n} E={len(u)} "
          f"(SNAP publishes N={n_nodes} E={n_edges})")
    if abs(len(u) - n_edges) > 0.01 * n_edges:
        raise RuntimeError(f"{name}: edge count {len(u)} is >1% off the "
                           f"published {n_edges} — corrupt download?")
    return txt_path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dest", default="data")
    ap.add_argument("--rungs", nargs="*", default=list(LADDER))
    args = ap.parse_args()
    try:
        import socket
        socket.getaddrinfo("snap.stanford.edu", 443)
    except OSError:
        print("ERROR: no network egress from this machine "
              "(snap.stanford.edu does not resolve). Run this script "
              "where outbound HTTPS works, then copy --dest here.",
              file=sys.stderr)
        return 2
    for name in args.rungs:
        fetch(name, args.dest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
