"""Registry, factory and the PretrainedModel contract."""
