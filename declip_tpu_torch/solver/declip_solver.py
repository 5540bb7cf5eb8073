"""CLI alias: `python -m declip_tpu_torch.solver.declip_solver --config ...`
mirrors the reference's per-method entry point
(prototype/solver/declip_solver.py). The generic Solver dispatches on the
model type, so all aliases share one engine."""

from declip_tpu_torch.solver import main

if __name__ == "__main__":
    main()
