"""World-steps (worlds x steps) completed in the window, over its seconds."""


def read(run):
    return run.world_steps / run.seconds
