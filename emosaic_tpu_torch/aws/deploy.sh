#!/usr/bin/env bash
# Deploy the tile-flag backend (reference surface: aws-backend/deploy.sh).
# Packages the lambdas, uploads to S3, deploys the CloudFormation stack.
set -euo pipefail

ENVIRONMENT="${ENVIRONMENT:-prod}"
AWS_REGION="${AWS_REGION:-us-east-1}"
CORS_ORIGIN="${CORS_ORIGIN:-*}"
CODE_BUCKET="${CODE_BUCKET:?set CODE_BUCKET to an S3 bucket for lambda code}"
STACK_NAME="${STACK_NAME:-${ENVIRONMENT}-emosaic-flag-backend}"

HERE="$(cd "$(dirname "$0")" && pwd)"
BUILD_DIR="$(mktemp -d)"
trap 'rm -rf "$BUILD_DIR"' EXIT

echo "📦 Packaging lambdas..."
cp "$HERE"/lambda/*.py "$BUILD_DIR/"
(cd "$BUILD_DIR" && zip -q lambda.zip ./*.py)

CODE_KEY="emosaic-flag-backend/lambda-$(date +%s).zip"
echo "☁️  Uploading code to s3://$CODE_BUCKET/$CODE_KEY"
aws s3 cp "$BUILD_DIR/lambda.zip" "s3://$CODE_BUCKET/$CODE_KEY" --region "$AWS_REGION"

echo "🚀 Deploying stack $STACK_NAME"
aws cloudformation deploy \
  --region "$AWS_REGION" \
  --stack-name "$STACK_NAME" \
  --template-file "$HERE/cloudformation/flag-backend.yaml" \
  --capabilities CAPABILITY_IAM \
  --parameter-overrides \
    "Environment=$ENVIRONMENT" \
    "CorsOrigin=$CORS_ORIGIN" \
    "LambdaCodeBucket=$CODE_BUCKET" \
    "LambdaCodeKey=$CODE_KEY"

ENDPOINT=$(aws cloudformation describe-stacks \
  --region "$AWS_REGION" --stack-name "$STACK_NAME" \
  --query "Stacks[0].Outputs[?OutputKey=='ApiEndpoint'].OutputValue" --output text)
echo "✅ API endpoint: $ENDPOINT"
echo "   Wire it into the widget with: $HERE/update-api-endpoint.sh <widget.html> $ENDPOINT"
