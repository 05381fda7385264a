"""Lambda: toggle a tile flag (reference surface: aws-backend/lambda/toggle_flag.py).

Routes (API Gateway proxy integration):
  POST   /tiles/{tileHash}/flag   -> set flag
  DELETE /tiles/{tileHash}/flag   -> remove flag

Storage: DynamoDB flag table (`{env}-tile-flags`, key tileHash) plus an IP
rate-limit table (`{env}-rate-limits`, TTL'd) enforcing 10 flags/min/IP —
the same envelope as the reference (toggle_flag.py:35-40,
aws-backend/README.md:145-149).

Quota: the reference's API Gateway UsagePlan grants 1000 requests/day
with 10 RPS / 20 burst (api-gateway.yaml:157-168). The HTTP API v2
stage throttle covers the rate side; the DAILY quota is enforced here —
an atomic per-day DynamoDB counter scoped by a REGISTERED `x-api-key`
(the API_KEYS env allowlist, mirroring gateway-registered keys). Any
other request — no key, or an unregistered/spoofed key — is scoped by
client IP (which is what the reference widget's keyless calls get).
Counters are TTL'd two days out.
"""

from __future__ import annotations

import json
import os
import time

RATE_LIMIT_PER_MINUTE = 10
DAILY_QUOTA = int(os.environ.get("DAILY_QUOTA", "1000"))
#: registered API keys (comma-separated env, mirroring the reference's
#: gateway-registered keys): an UNREGISTERED x-api-key must NOT become a
#: quota scope — a spoofer minting random keys would get a fresh daily
#: budget per request, bypassing the per-IP fallback entirely
API_KEYS = frozenset(
    k for k in os.environ.get("API_KEYS", "").split(",") if k
)
_TABLE = None
_RATE_TABLE = None


def _tables():
    global _TABLE, _RATE_TABLE
    if _TABLE is None:
        import boto3  # available in the Lambda runtime

        env = os.environ.get("ENVIRONMENT", "prod")
        ddb = boto3.resource("dynamodb")
        _TABLE = ddb.Table(f"{env}-tile-flags")
        _RATE_TABLE = ddb.Table(f"{env}-rate-limits")
    return _TABLE, _RATE_TABLE


def _response(status: int, body: dict) -> dict:
    return {
        "statusCode": status,
        "headers": {
            "Content-Type": "application/json",
            "Access-Control-Allow-Origin": os.environ.get("CORS_ORIGIN", "*"),
            "Access-Control-Allow-Methods": "POST,DELETE,OPTIONS",
            "Access-Control-Allow-Headers": "Content-Type",
        },
        "body": json.dumps(body),
    }


def _client_ip(event: dict) -> str:
    ctx = event.get("requestContext", {})
    identity = ctx.get("identity", {}) or ctx.get("http", {})
    return identity.get("sourceIp", "unknown")


def quota_scope(event: dict, api_keys=None) -> str:
    """Quota scope: a REGISTERED x-api-key, else the client IP."""
    keys = API_KEYS if api_keys is None else api_keys
    headers = {k.lower(): v for k, v in (event.get("headers") or {}).items()}
    key = headers.get("x-api-key")
    if key and key in keys:
        return key
    return _client_ip(event)


def check_daily_quota(rate_table, scope: str, quota: int) -> bool:
    """Atomic per-day counter (UsagePlan Quota parity: Limit 1000/DAY).

    Fail-open on DynamoDB errors (ADVICE r3): a throttled/unavailable
    rate-limits table must not turn every flag read and write into a 500
    — the reference's gateway UsagePlan never fails closed either. The
    error is logged for CloudWatch."""
    now = int(time.time())
    day = time.strftime("%Y%m%d", time.gmtime(now))
    try:
        resp = rate_table.update_item(
            Key={"key": f"quota#{scope}#{day}"},
            UpdateExpression=(
                "ADD #n :one SET expiresAt = if_not_exists(expiresAt, :exp)"
            ),
            ExpressionAttributeNames={"#n": "n"},
            ExpressionAttributeValues={":one": 1, ":exp": now + 2 * 86400},
            ReturnValues="UPDATED_NEW",
        )
    except Exception as e:  # noqa: BLE001 — botocore ClientError et al.
        print(f"quota check degraded (fail-open): {type(e).__name__}: {e}")
        return True
    return int(resp["Attributes"]["n"]) <= quota


def _check_rate_limit(rate_table, ip: str) -> bool:
    """Sliding one-minute window per IP, entries expired via DynamoDB TTL.

    Fail-open on DynamoDB errors, same rationale as check_daily_quota: a
    throttled/unavailable rate-limits table must not turn every flag
    toggle into a 500 (the reference's limiter lives in the gateway and
    never fails closed either)."""
    now = int(time.time())
    window_start = now - 60
    key = f"flag#{ip}"
    try:
        item = rate_table.get_item(Key={"key": key}).get("Item")
        times = [
            t for t in (item or {}).get("times", []) if int(t) > window_start
        ]
        if len(times) >= RATE_LIMIT_PER_MINUTE:
            return False
        times.append(now)
        rate_table.put_item(
            Item={"key": key, "times": times, "expiresAt": now + 120}
        )
    except Exception as e:  # noqa: BLE001 — botocore ClientError et al.
        print(f"rate limit degraded (fail-open): {type(e).__name__}: {e}")
        return True
    return True


def handler(event, context):
    method = (
        event.get("httpMethod")
        or event.get("requestContext", {}).get("http", {}).get("method", "")
    ).upper()
    if method == "OPTIONS":
        return _response(200, {})

    # validate BEFORE any quota/rate bookkeeping (ADVICE r3): malformed
    # requests must not consume quota units — the reference UsagePlan only
    # counts gateway-accepted requests
    if method not in ("POST", "DELETE"):
        return _response(405, {"error": f"method {method} not allowed"})
    tile_hash = (event.get("pathParameters") or {}).get("tileHash", "")
    if not tile_hash or len(tile_hash) > 64 or not tile_hash.isalnum():
        return _response(400, {"error": "invalid tileHash"})

    table, rate_table = _tables()
    ip = _client_ip(event)
    if not check_daily_quota(rate_table, quota_scope(event), DAILY_QUOTA):
        return _response(
            429, {"error": f"daily quota exceeded ({DAILY_QUOTA}/day)"}
        )
    if not _check_rate_limit(rate_table, ip):
        return _response(
            429, {"error": f"rate limit exceeded ({RATE_LIMIT_PER_MINUTE}/min)"}
        )

    if method == "POST":
        body = {}
        try:
            body = json.loads(event.get("body") or "{}")
        except json.JSONDecodeError:
            pass
        table.put_item(
            Item={
                "tileHash": tile_hash,
                "tilePath": str(body.get("tilePath", ""))[:1024],
                "flaggedAt": int(time.time()),
                "flaggedBy": ip,
            }
        )
        return _response(200, {"tileHash": tile_hash, "flagged": True})

    # method == "DELETE" (validated above)
    table.delete_item(Key={"tileHash": tile_hash})
    return _response(200, {"tileHash": tile_hash, "flagged": False})
