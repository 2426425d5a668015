from .fmt import format_estimate, create_temp_dir

__all__ = ["format_estimate", "create_temp_dir"]
