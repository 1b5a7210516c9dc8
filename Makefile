# Build + deploy entry points.  The reference ships one prebuilt image
# (nizepart/mlflow-operator:latest, README.md:32); this framework builds
# its three first-party images from source.

# bash, not sh: the verify recipe needs pipefail/PIPESTATUS (dash has
# neither and dies on `set -o pipefail`).
SHELL    := /bin/bash

PKG      := research_and_development_of_kubernetes_operator_for_machine_learning_pipelines_tpu
TORCH_PKG := $(PKG)_torch
REGISTRY ?= tpumlops
TAG      ?= latest
DOCKER   ?= docker

.PHONY: images operator-image server-image router-image router-bin \
        torch-images torch-operator-image torch-server-image torch-router-image \
        install uninstall test test-fast test-e2e test-all lint \
        bench-contract metrics-contract compile-budget plan-contract \
        bench-history metrics-catalog torch-plan-contract torch-metrics-catalog \
        verify bench

images: operator-image server-image router-image

operator-image:
	$(DOCKER) build -f $(PKG)/deploy/docker/Dockerfile.operator \
	  -t $(REGISTRY)/operator:$(TAG) .

server-image:
	$(DOCKER) build -f $(PKG)/deploy/docker/Dockerfile.server \
	  -t $(REGISTRY)/jax-server:$(TAG) .

router-image:
	$(DOCKER) build -f $(PKG)/deploy/docker/Dockerfile.router \
	  -t $(REGISTRY)/router:$(TAG) .

# The PyTorch/CUDA port's three images (its deploy/ names them).
torch-images: torch-operator-image torch-server-image torch-router-image

torch-operator-image:
	$(DOCKER) build -f $(TORCH_PKG)/deploy/docker/Dockerfile.operator \
	  -t $(REGISTRY)/torch-operator:$(TAG) .

torch-server-image:
	$(DOCKER) build -f $(TORCH_PKG)/deploy/docker/Dockerfile.server \
	  -t $(REGISTRY)/torch-server:$(TAG) .

torch-router-image:
	$(DOCKER) build -f $(TORCH_PKG)/deploy/docker/Dockerfile.router \
	  -t $(REGISTRY)/torch-router:$(TAG) .

# Local (no docker): compile the native router with the system toolchain.
router-bin:
	mkdir -p build
	g++ -O2 -std=c++17 -Wall -o build/router $(PKG)/native/router.cc

# Cluster install, mirroring the reference's README steps (:25-64):
# CRD -> RBAC -> operator Deployment.  Assumes the mlflow-creds secret
# exists in tpumlops-system (MLFLOW_TRACKING_URI + credentials).
install:
	kubectl apply -f $(PKG)/deploy/crd.yaml
	kubectl apply -f $(PKG)/deploy/rbac.yaml
	kubectl apply -f $(PKG)/deploy/operator-deployment.yaml

uninstall:
	kubectl delete -f $(PKG)/deploy/operator-deployment.yaml --ignore-not-found
	kubectl delete -f $(PKG)/deploy/rbac.yaml --ignore-not-found
	kubectl delete -f $(PKG)/deploy/crd.yaml --ignore-not-found

# Cost tranches (VERDICT r3 #10): `test-fast` is the unit core (~3 min);
# `test-all` adds the e2e (live servers / envtest apiserver) and slow
# (compile- and subprocess-heavy) tranches — the full suite exceeds a
# 10-minute wall in remote-compile environments.
test: test-fast

test-fast:
	python -m pytest tests/ -x -q -m "not e2e and not slow"

test-e2e:
	python -m pytest tests/ -x -q -m "e2e or slow"

test-all:
	python -m pytest tests/ -x -q

# Ruff (config in pyproject.toml [tool.ruff]): pyflakes/pycodestyle
# error classes over the first-party tree.  Soft dependency — the
# serving image does not bake a linter, so environments without ruff
# skip with a notice instead of failing verify (CI images install it:
# `pip install ruff`).
lint:
	@if command -v ruff >/dev/null 2>&1; then \
	  ruff check .; \
	else \
	  echo "lint: ruff not installed; skipping (pip install ruff)"; \
	fi

# Bench driver-contract gate: a --dry-run invocation (validates the
# scenario registry and prints the schema contract without touching a
# device) plus the contract tests that pin it — scenario schema drift
# fails HERE, locally, instead of surfacing as a missing field in a
# round's official record.
bench-contract:
	python bench.py --dry-run > /dev/null
	python -m pytest tests/test_bench_contract.py -q

# Metric-identity contract gate (SURVEY §7 hard part 4): the promotion
# gate's PromQL — and every dashboard/alert — reads these exact family
# names and label sets.  An accidental rename must fail HERE, locally,
# not as a gate query silently reading 0 through its vector(0) fallback.
metrics-contract:
	env JAX_PLATFORMS=cpu python -m pytest tests/test_metrics_contract.py -q

# The EXACT tier-1 command from ROADMAP.md (the driver's acceptance
# gate) chained behind lint + the bench contract: not-slow tranche,
# collection errors tolerated, 870 s wall cap, DOTS_PASSED echoed from
# the captured dot lines.
# Compile-budget regression gate (ISSUE 16): the unified super-step
# engine's whole point is a small program space.  Runs both warmup
# sweeps on the tiny model with the compile observatory attached and
# fails if the unified jit-variant count, the legacy/unified collapse
# ratio, or the compile-seconds total regresses past the committed
# budget in COMPILE_BUDGET.json.
compile-budget:
	env JAX_PLATFORMS=cpu python scripts/check_compile_budget.py

# Plan-contract gate (ISSUE 18): the offline SLO planner's output is a
# pure function of (trace, objective, cost model, grid) — re-planning
# the committed fixture trace must reproduce the committed plan JSON
# byte-for-byte.  Cost-model drift fails HERE, locally, instead of
# silently re-shaping fleets the next time a CR's planner runs.
plan-contract:
	env JAX_PLATFORMS=cpu python scripts/plan.py --dry-run \
	  --expect tests/fixtures/journey_plan.json > /dev/null

# Bench regression sentinel (ISSUE 20): every committed BENCH_*.json's
# headline keys versus their last BENCH_HISTORY.jsonl revision — a
# silent tok/s or collapse-ratio regression fails here, in the diff.
bench-history:
	python scripts/check_bench_history.py

# Metrics-catalog lint (ISSUE 20): the three OBSERVABILITY.md series
# tables must enumerate EXACTLY the families the server / operator /
# router planes export — both directions.
metrics-catalog:
	env JAX_PLATFORMS=cpu python scripts/check_metrics_catalog.py

# The port's planner on the H100's rooflines: its own committed plan of
# the same fixture trace, byte for byte.
torch-plan-contract:
	python -m $(TORCH_PKG).scripts.plan --dry-run \
	  --expect tests/fixtures/journey_plan_h100.json > /dev/null

# The port's three planes against the same catalog, both directions.
torch-metrics-catalog:
	python -m $(TORCH_PKG).scripts.check_metrics_catalog

verify: lint bench-contract metrics-contract compile-budget plan-contract \
        bench-history metrics-catalog
	set -o pipefail; rm -f /tmp/_t1.log; \
	timeout -k 10 1150 env JAX_PLATFORMS=cpu python -m pytest tests/ -q \
	  -m 'not slow' --continue-on-collection-errors -p no:cacheprovider \
	  -p no:xdist -p no:randomly 2>&1 | tee /tmp/_t1.log; \
	rc=$${PIPESTATUS[0]}; \
	echo DOTS_PASSED=$$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$$' /tmp/_t1.log | tr -cd . | wc -c); \
	exit $$rc

bench:
	python bench.py
