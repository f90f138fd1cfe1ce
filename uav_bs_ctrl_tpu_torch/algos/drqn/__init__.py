"""Single-agent DRQN (exp1): the learner and the fused on-device trainer."""
