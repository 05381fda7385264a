"""Lambda: admin listing of all flags
(reference surface: aws-backend/lambda/admin_get_all_flags.py).

Route: GET /admin/flags[?pageSize=N&startKey=...]. Paginated DynamoDB scan
with summary statistics.
"""

from __future__ import annotations

import json
import os

_TABLE = None
DEFAULT_PAGE_SIZE = 100
MAX_PAGE_SIZE = 1000


def _table():
    global _TABLE
    if _TABLE is None:
        import boto3

        env = os.environ.get("ENVIRONMENT", "prod")
        _TABLE = boto3.resource("dynamodb").Table(f"{env}-tile-flags")
    return _TABLE


def _response(status: int, body: dict) -> dict:
    return {
        "statusCode": status,
        "headers": {
            "Content-Type": "application/json",
            "Access-Control-Allow-Origin": os.environ.get("CORS_ORIGIN", "*"),
        },
        "body": json.dumps(body, default=str),
    }


def handler(event, context):
    params = event.get("queryStringParameters") or {}
    try:
        page_size = min(
            int(params.get("pageSize", DEFAULT_PAGE_SIZE)), MAX_PAGE_SIZE
        )
    except ValueError:
        page_size = DEFAULT_PAGE_SIZE

    scan_kwargs = {"Limit": page_size}
    start_key = params.get("startKey")
    if start_key:
        scan_kwargs["ExclusiveStartKey"] = {"tileHash": start_key}

    table = _table()
    resp = table.scan(**scan_kwargs)
    items = resp.get("Items", [])
    flagged_by: dict[str, int] = {}
    oldest = None
    newest = None
    for it in items:
        ip = str(it.get("flaggedBy", "unknown"))
        flagged_by[ip] = flagged_by.get(ip, 0) + 1
        at = int(it.get("flaggedAt", 0))
        oldest = at if oldest is None else min(oldest, at)
        newest = at if newest is None else max(newest, at)

    body = {
        "flags": items,
        "count": len(items),
        "summary": {
            "uniqueFlaggers": len(flagged_by),
            "byFlagger": flagged_by,
            "oldestFlaggedAt": oldest,
            "newestFlaggedAt": newest,
        },
    }
    last_key = resp.get("LastEvaluatedKey")
    if last_key:
        body["nextStartKey"] = last_key.get("tileHash")
    return _response(200, body)
