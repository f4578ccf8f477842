"""Interop Avro schemas — the reference's on-disk data/model formats.

Port of the feature, model and score schemas of
``photon_ml_tpu/io/schemas.py`` (copies: the port imports nothing of the
JAX package), Python-dict renditions of photon-avro-schemas/src/main/avro/
in the reference: ``FeatureAvro`` (a GAME row's feature sections),
``BayesianLinearModelAvro`` + ``NameTermValueAvro`` (coefficient models),
``LatentFactorAvro`` (matrix-factorization factor rows) and
``ScoringResultAvro`` (scores), and the legacy driver's
``TrainingExampleAvro`` and ``ResponsePredictionAvro`` (a labeled row)
and ``FeatureSummarizationResultAvro`` (its feature summary).
"""

NAMESPACE = "com.linkedin.photon.avro.generated"

NAME_TERM_VALUE = {
    "name": "NameTermValueAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

FEATURE = {
    "name": "FeatureAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}


TRAINING_EXAMPLE = {
    "name": "TrainingExampleAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE}},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

# The GAME drivers' "response prediction" naming convention: the label field
# is called "response" (avro/ResponsePredictionFieldNames.scala:21-28).
RESPONSE_PREDICTION = {
    "name": "ResponsePredictionAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE}},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

BAYESIAN_LINEAR_MODEL = {
    "name": "BayesianLinearModelAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means",
         "type": {"type": "array", "items": NAME_TERM_VALUE}},
        {"name": "variances",
         "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
         "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}


LATENT_FACTOR = {
    "name": "LatentFactorAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor",
         "type": {"type": "array", "items": "double"}},
    ],
}

SCORING_RESULT = {
    "name": "ScoringResultAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}],
         "default": None},
    ],
}

FEATURE_SUMMARIZATION_RESULT = {
    "name": "FeatureSummarizationResultAvro",
    "namespace": NAMESPACE,
    "type": "record",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}
