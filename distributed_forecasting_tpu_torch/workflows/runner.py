"""YAML workflow runner (port of the reference's ``workflows/runner.py``):
topological, in-process execution of task nodes with explicit
``depends_on`` edges, per-task conf (inline or ``conf_file``), shared
``env`` roots, and fail-fast with a structured result report.

    python -m distributed_forecasting_tpu_torch.workflows.runner \\
        -f conf/workflows.yml -w forecasting-e2e

Every task runs on the runner's device: ``cuda`` unless the caller asks for
the CPU (``device="cpu"``, or ``DFTPU_PLATFORM=cpu`` on the command line).
The port knows every task type of the reference's runner; a node with any
other type stops the workflow there with a :class:`WorkflowError` naming
it, after the nodes before it ran.

Workflow YAML::

    env:
      root: ./dftpu_store
    workflows:
      - name: forecasting-e2e
        tasks:
          - name: catalog
            task: catalog                # key into TASK_TYPES
            conf_file: conf/tasks/catalog_config.yml
          - name: etl
            task: ingest
            depends_on: [catalog]
            conf: {...}
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from distributed_forecasting_tpu_torch.utils.config import load_conf
from distributed_forecasting_tpu_torch.utils.device import (
    platform_device,
    resolve_device,
)
from distributed_forecasting_tpu_torch.utils.logging import get_logger


class WorkflowError(RuntimeError):
    pass


class WorkflowRunner:
    def __init__(self, spec: Dict[str, Any], env: Optional[Dict[str, Any]] = None,
                 device=None):
        self.spec = spec
        self.env = {**(spec.get("env", {}) or {}), **(env or {})}
        self.device = resolve_device(platform_device(device))
        self.logger = get_logger("WorkflowRunner")

    def _workflow(self, name: Optional[str]) -> Dict[str, Any]:
        flows = self.spec.get("workflows", [])
        if not flows:
            raise WorkflowError("no workflows defined")
        if name is None:
            return flows[0]
        for wf in flows:
            if wf.get("name") == name:
                return wf
        raise WorkflowError(f"workflow {name!r} not found")

    @staticmethod
    def _topo_order(tasks: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        by_name = {t["name"]: t for t in tasks}
        order: List[Dict[str, Any]] = []
        state: Dict[str, int] = {}  # 1 done

        def visit(name: str, chain=()):
            if name in chain:
                raise WorkflowError(f"dependency cycle at {name!r}")
            if state.get(name) == 1:
                return
            node = by_name.get(name)
            if node is None:
                raise WorkflowError(f"unknown dependency {name!r}")
            for dep in node.get("depends_on", []) or []:
                visit(dep, chain + (name,))
            state[name] = 1
            order.append(node)

        for t in tasks:
            visit(t["name"])
        return order

    def run(self, workflow: Optional[str] = None) -> Dict[str, Any]:
        from distributed_forecasting_tpu_torch.tasks import TASK_TYPES

        wf = self._workflow(workflow)
        order = self._topo_order(wf.get("tasks", []))
        self.logger.info(
            "workflow %s: %d tasks (%s) on %s",
            wf.get("name"), len(order), " -> ".join(t["name"] for t in order),
            self.device,
        )
        results: Dict[str, Any] = {}
        for node in order:
            ttype = node.get("task")
            if ttype not in TASK_TYPES:
                raise WorkflowError(
                    f"task {node['name']!r}: unknown task type {ttype!r} "
                    f"(known: {sorted(TASK_TYPES)})"
                )
            conf: Dict[str, Any] = {}
            if node.get("conf_file"):
                conf.update(load_conf(node["conf_file"]))
            if node.get("conf"):
                conf.update(node["conf"])
            if self.env:
                conf.setdefault("env", {}).update(
                    {k: v for k, v in self.env.items() if k not in conf.get("env", {})}
                )
            t0 = time.time()
            self.logger.info("task %s (%s) starting", node["name"], ttype)
            try:
                out = TASK_TYPES[ttype](init_conf=conf,
                                        device=self.device).launch()
            except Exception as e:
                self.logger.error("task %s failed: %s", node["name"], e)
                results[node["name"]] = {"status": "FAILED", "error": str(e)}
                raise WorkflowError(f"task {node['name']} failed: {e}") from e
            results[node["name"]] = {
                "status": "OK",
                "seconds": time.time() - t0,
                "result": out,
            }
        return results


def run_workflow_file(path: str, workflow: Optional[str] = None,
                      env: Optional[Dict[str, Any]] = None,
                      device=None) -> Dict[str, Any]:
    return WorkflowRunner(load_conf(path), env=env, device=device).run(workflow)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("dftpu-workflow (PyTorch port)")
    p.add_argument("--file", "-f", required=True, help="workflow YAML")
    p.add_argument("--workflow", "-w", default=None, help="workflow name")
    p.add_argument("--env-root", default=None, help="override env.root")
    args = p.parse_args(argv)
    env = {"root": args.env_root} if args.env_root else None
    results = run_workflow_file(args.file, args.workflow, env=env)
    for name, r in results.items():
        print(f"{name}: {r['status']} ({r.get('seconds', 0):.2f}s)")


if __name__ == "__main__":
    main()
