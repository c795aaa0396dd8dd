from .plan_serde import deserialize_plan, serialize_plan  # noqa: F401
