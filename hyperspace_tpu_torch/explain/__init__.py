from hyperspace_tpu_torch.explain.plan_analyzer import explain_string, pretty_plan

__all__ = ["explain_string", "pretty_plan"]
