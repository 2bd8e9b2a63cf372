"""Transform worker — the isolated job entrypoint.

Analog of the reference's Spark runner CLI
(``provider/scripts/spark/offline_store_spark_runner.py``: ``main``
:75, ``execute_sql_query`` :851, ``execute_df_job`` :1112, argparse
:1480) and of ``runner/worker/worker.go:22``: a standalone process that
receives a self-contained job spec, executes the transformation, and
writes output rows — no provider credentials, no metadata access.

Usage:
    python -m embeddinghub_tpu_torch.featurestore.transform_worker \
        --spec job.spec.json --output job.out.json
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ehtpu-transform-worker")
    ap.add_argument("--spec", required=True, help="job spec JSON path")
    ap.add_argument("--output", required=True, help="output rows JSON path")
    args = ap.parse_args(argv)

    from embeddinghub_tpu_torch.featurestore.transform_engine import execute_spec

    with open(args.spec) as f:
        spec = json.load(f)
    rows = execute_spec(spec)
    with open(args.output, "w") as f:
        json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
