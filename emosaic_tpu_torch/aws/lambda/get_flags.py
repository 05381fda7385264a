"""Lambda: bulk flag lookup (reference surface: aws-backend/lambda/get_flags.py).

Route: POST /tiles/flags with body {"tileHashes": [...]}; at most 100
hashes per request (get_flags.py:27-28). Returns {"flags": {hash: bool}}.

Shares the daily-quota enforcement with toggle_flag (the reference's
UsagePlan quota, api-gateway.yaml:166-168, applies to the whole API).
"""

from __future__ import annotations

import json
import os

MAX_HASHES = 100
DAILY_QUOTA = int(os.environ.get("DAILY_QUOTA", "1000"))
_TABLE = None
_RATE_TABLE = None


def _table():
    global _TABLE
    if _TABLE is None:
        import boto3

        env = os.environ.get("ENVIRONMENT", "prod")
        _TABLE = boto3.resource("dynamodb").Table(f"{env}-tile-flags")
    return _TABLE


def _rate_table():
    global _RATE_TABLE
    if _RATE_TABLE is None:
        import boto3

        env = os.environ.get("ENVIRONMENT", "prod")
        _RATE_TABLE = boto3.resource("dynamodb").Table(f"{env}-rate-limits")
    return _RATE_TABLE


def _check_daily_quota(event: dict) -> bool:
    # both handlers deploy from the same zip (flag-backend.yaml shares
    # one LambdaCodeKey), so the enforcement logic lives once in
    # toggle_flag — a divergent copy here would silently split the
    # quota semantics across routes. Lazy import: test harnesses load
    # these files standalone and register toggle_flag first.
    import toggle_flag

    return toggle_flag.check_daily_quota(
        _rate_table(), toggle_flag.quota_scope(event), DAILY_QUOTA
    )


def _response(status: int, body: dict) -> dict:
    return {
        "statusCode": status,
        "headers": {
            "Content-Type": "application/json",
            "Access-Control-Allow-Origin": os.environ.get("CORS_ORIGIN", "*"),
            "Access-Control-Allow-Methods": "POST,OPTIONS",
            "Access-Control-Allow-Headers": "Content-Type",
        },
        "body": json.dumps(body),
    }


def handler(event, context):
    method = (
        event.get("httpMethod")
        or event.get("requestContext", {}).get("http", {}).get("method", "")
    ).upper()
    if method == "OPTIONS":
        return _response(200, {})

    try:
        body = json.loads(event.get("body") or "{}")
    except json.JSONDecodeError:
        return _response(400, {"error": "invalid JSON body"})

    # validate before the quota check (ADVICE r3): malformed requests
    # must not consume daily-quota units
    hashes = body.get("tileHashes")
    if not isinstance(hashes, list) or not hashes:
        return _response(400, {"error": "tileHashes must be a non-empty list"})
    if len(hashes) > MAX_HASHES:
        return _response(400, {"error": f"at most {MAX_HASHES} hashes per request"})
    # sanitize BEFORE the quota check too: a list of entirely-invalid
    # hashes is a malformed request and must not burn a quota unit
    hashes = [str(h) for h in hashes if str(h).isalnum() and len(str(h)) <= 64]
    if not hashes:
        return _response(400, {"error": "no valid tileHashes"})

    if not _check_daily_quota(event):
        return _response(
            429, {"error": f"daily quota exceeded ({DAILY_QUOTA}/day)"}
        )

    table = _table()
    flags: dict[str, bool] = {}
    # BatchGetItem in chunks of 100 keys (DynamoDB limit)
    import boto3  # noqa: F401

    client = table.meta.client
    for i in range(0, len(hashes), 100):
        chunk = hashes[i : i + 100]
        resp = client.batch_get_item(
            RequestItems={
                table.name: {"Keys": [{"tileHash": h} for h in chunk]}
            }
        )
        found = {
            item["tileHash"] for item in resp.get("Responses", {}).get(table.name, [])
        }
        for h in chunk:
            flags[h] = h in found
    return _response(200, {"flags": flags, "count": sum(flags.values())})
