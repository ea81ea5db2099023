from .synthetic import RoomScene, render_frame, write_dataset  # noqa: F401
