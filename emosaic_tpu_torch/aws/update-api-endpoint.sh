#!/usr/bin/env bash
# Point a generated widget at the deployed flag API
# (reference surface: aws-backend/update-api-endpoint.sh).
# Injects `window.MOSAIC_FLAG_API = "<endpoint>"` into the widget HTML head.
set -euo pipefail

WIDGET_HTML="${1:?usage: update-api-endpoint.sh WIDGET_HTML API_ENDPOINT}"
ENDPOINT="${2:?usage: update-api-endpoint.sh WIDGET_HTML API_ENDPOINT}"

if grep -q "MOSAIC_FLAG_API" "$WIDGET_HTML"; then
  sed -i "s|window.MOSAIC_FLAG_API = \"[^\"]*\"|window.MOSAIC_FLAG_API = \"$ENDPOINT\"|" "$WIDGET_HTML"
else
  sed -i "s|<head>|<head>\n    <script>window.MOSAIC_FLAG_API = \"$ENDPOINT\";</script>|" "$WIDGET_HTML"
fi
echo "✅ $WIDGET_HTML now targets $ENDPOINT"
