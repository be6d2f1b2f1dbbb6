"""The rolling driver upgrade: the per-node FSM, its managers and the
slice-unit disruption budget it shares with remediation and the
re-partition roll (``upgrade_state``), and the reconciler that steps it
under the rollout's cohort gate (``upgrade_controller``)."""
